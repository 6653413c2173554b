"""The ``pdftable`` command line (counterpart of pdf_table_tpu/cli)."""
