from .grid import GridCell, build_grid_cells
from .algo import extract_cells_from_image, find_table_lines
from .from_pdf import (detect_table_regions, extract_cells_from_pdf_page,
                       pdf_page_lines)

__all__ = ["GridCell", "build_grid_cells", "extract_cells_from_image",
           "find_table_lines", "extract_cells_from_pdf_page",
           "pdf_page_lines", "detect_table_regions"]
