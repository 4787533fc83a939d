"""Runtime layout and analysis: the logical-axis rules (``sharding``),
elastic re-mesh (``elastic``), the op-level step analysis and its
breakdown (``op_analysis``, ``op_breakdown``) and the H100 roofline
(``roofline``)."""
