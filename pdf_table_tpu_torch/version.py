"""The port's version (counterpart of pdf_table_tpu/version.py)."""

__version__ = "0.1.0"
