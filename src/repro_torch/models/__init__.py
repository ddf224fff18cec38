"""Models of the port: the paper's DLRMs (``models/tabular.py``) and the
LLM split models (``models/vfl.py`` over ``backbone.py`` / ``layers.py``,
with ``moe.py``, ``ssm.py`` and ``xlstm.py``: the dense, moe, hybrid and
ssm / xlstm text families, and the vlm and audio families, whose towers
cross-attend to the other party's Z)."""
