"""Entry points: the serving, quantize and train CLIs, the step
functions and the recompute oracle."""
