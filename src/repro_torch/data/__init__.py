from repro_torch.data.partition import partition
from repro_torch.data.pipeline import batches, epoch_count_steps
from repro_torch.data.synthetic import Dataset, make_digits, make_token_stream

__all__ = ["Dataset", "batches", "epoch_count_steps", "make_digits",
           "make_token_stream", "partition"]
