from .vocab import Vocabulary
from .hdf5 import FeatureStore
from .tokenizers import (
    ClipBPETokenizer,
    GloVeSimpleTokenizer,
    NLTKTokenizer,
    NLTKFeatureTokenizer,
)
from .datasets import (
    CharadesDataset,
    CharadesCGDataset,
    CharadesCDDataset,
    TACoSDataset,
    QVHighlightsDataset,
    build_dataset,
)
from .collate import BatchSpec, make_collate
from .sampler import GroupAwareBatcher, RowBudgetBatcher
from .pipeline import Loader, device_feed, stage_batch
