"""repro_torch.data — the port's training input: a corpus of small sample
files over a storage client (`BuffetDataset`), read by a prefetching,
hedging `DataPipeline`; `DirLib`, the client's calls on a local directory;
the sampler, the record format and batch packing; `corpus_batches`, the
same batches from an in-memory corpus."""
from .dataset import BuffetDataset, DatasetSpec
from .dirfs import DirLib
from .pipeline import DataPipeline, PipelineStats, corpus_batches
from .sampler import ShardedSampler
from .tokens import decode_sample, encode_sample, pack_batch

__all__ = ["BuffetDataset", "DatasetSpec", "DataPipeline", "DirLib", "PipelineStats",
           "ShardedSampler", "corpus_batches", "decode_sample", "encode_sample",
           "pack_batch"]
