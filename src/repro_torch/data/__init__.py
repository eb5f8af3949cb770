from .loader import MBSLoader  # noqa: F401
from .synthetic import (ClassificationDataset, LMDataset,  # noqa: F401
                        SegmentationDataset, minibatch_stream)
