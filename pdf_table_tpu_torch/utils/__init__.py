"""Helpers of the port (counterpart of pdf_table_tpu/utils)."""
