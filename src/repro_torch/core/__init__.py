"""Incoherence transforms, bit packing and the packed QuantizedLinear."""
