from .column import Column
from .table import Table

__all__ = ["Column", "Table"]
