"""Runtime layout: the logical-axis rules tensor-parallel serving reads."""
