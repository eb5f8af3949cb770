from .loader import MBSLoader  # noqa: F401
from .synthetic import LMDataset  # noqa: F401
