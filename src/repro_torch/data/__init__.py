from .synthetic import LMDataset  # noqa: F401
