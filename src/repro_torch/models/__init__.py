"""Models of the port: the paper's DLRMs (``models/tabular.py``)."""
