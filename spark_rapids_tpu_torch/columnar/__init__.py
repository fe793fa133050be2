from .column import Column, make_string_column
from .table import Table

__all__ = ["Column", "Table", "make_string_column"]
