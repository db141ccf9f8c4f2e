from repro_torch.data.loader import batch_index_lists, batches, num_batches
from repro_torch.data.partition import (
    dirichlet_partition,
    iid_partition,
    image_federation,
    partition,
    pathological_partition,
)
from repro_torch.data.synthetic import (
    make_image_dataset,
    make_token_dataset,
    train_test_split,
)

__all__ = [
    "batch_index_lists", "batches", "num_batches", "dirichlet_partition",
    "iid_partition", "image_federation",
    "partition", "pathological_partition", "make_image_dataset",
    "make_token_dataset", "train_test_split",
]
