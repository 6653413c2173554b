"""DocXLayout: the DLA-34 CenterNet layout detector (counterpart of
pdf_table_tpu/models/docx_layout)."""
