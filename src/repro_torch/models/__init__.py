"""Models of the port: the paper's DLRMs (``models/tabular.py``) and the
LLM split models (``models/vfl.py`` over ``backbone.py`` / ``layers.py``,
the dense family)."""
