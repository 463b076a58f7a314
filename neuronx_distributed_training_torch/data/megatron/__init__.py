"""Megatron-style mmap pretraining datasets (.bin/.idx) with C++ index building."""

from neuronx_distributed_training_torch.data.megatron.dataset import (  # noqa: F401
    GPTDataset,
    IndexedDataset,
    write_indexed_dataset,
)
from neuronx_distributed_training_torch.data.megatron.index import (  # noqa: F401
    build_doc_idx,
    build_sample_idx,
    build_shuffle_idx,
)
