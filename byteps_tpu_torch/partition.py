"""Tensor partitioning and key-range assignment.

Capability parity with the reference's partitioner (SURVEY.md §2.1,
byteps/common/operations.cc ``InitTensor``): every declared tensor is split
into fixed-size byte slices (default ``BYTEPS_PARTITION_BYTES`` ≈ 4 MB), each
an independently scheduled unit, so one large tensor pipelines across
compression, push, summation, and pull, and its partitions spread across all
parameter servers (ps-lite ``Postoffice::GetServerKeyRanges`` equivalent).

TPU-first notes: partition sizes are computed on *flattened, padded* arrays
so shapes stay static under jit; the same partition table drives both the
host-side C++ PS path and the in-jit bucketing used for overlap.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """One independently-scheduled slice of a declared tensor."""

    key: int          # globally unique partition key (tensor_id << 16 | idx)
    tensor_id: int
    index: int        # partition index within the tensor
    offset: int       # element offset into the flattened tensor
    length: int       # element count of this slice
    server: int       # owning parameter-server rank (PS mode)
    priority: int     # scheduling priority (higher = sooner)


@dataclasses.dataclass(frozen=True)
class TensorEntry:
    """Per-declared-tensor state (reference: BytePSContext, common.h)."""

    tensor_id: int
    name: str
    shape: tuple
    dtype: str
    num_elements: int
    priority: int
    partitions: tuple  # tuple[Partition, ...]


MAX_PARTITIONS_PER_TENSOR = 1 << 16


def partition_tensor(
    tensor_id: int,
    name: str,
    shape: Sequence[int],
    dtype: str,
    *,
    partition_bytes: int,
    num_servers: int,
    priority: int,
) -> TensorEntry:
    """Split one tensor into partitions and assign each to a server.

    Server assignment mirrors the reference's load-balancing intent: partition
    ``i`` of tensor ``t`` goes to server ``(t + i) % num_servers`` so both the
    partitions of one large tensor and the single-partition small tensors
    spread evenly across servers.
    """
    itemsize = np.dtype(dtype).itemsize
    num_elements = int(np.prod(shape)) if len(shape) else 1
    per_part = max(1, partition_bytes // itemsize)
    n_parts = max(1, -(-num_elements // per_part))
    if n_parts >= MAX_PARTITIONS_PER_TENSOR:
        raise ValueError(
            f"tensor {name!r} needs {n_parts} partitions; raise "
            f"BYTEPS_PARTITION_BYTES (limit {MAX_PARTITIONS_PER_TENSOR})")
    ns = max(1, num_servers)
    parts: List[Partition] = []
    for i in range(n_parts):
        off = i * per_part
        length = min(per_part, num_elements - off)
        parts.append(
            Partition(
                key=(tensor_id << 16) | i,
                tensor_id=tensor_id,
                index=i,
                offset=off,
                length=length,
                server=(tensor_id + i) % ns,
                priority=priority,
            ))
    return TensorEntry(
        tensor_id=tensor_id,
        name=name,
        shape=tuple(shape),
        dtype=str(dtype),
        num_elements=num_elements,
        priority=priority,
        partitions=tuple(parts),
    )


class TensorRegistry:
    """Declaration-order registry of tensors (reference:
    ``byteps_declare_tensor`` + BytePSGlobal context table).

    Priority = negative declaration order: tensors declared earlier (closer
    to the model input) get *higher* priority, because the next forward pass
    needs their fresh values first (SURVEY.md §2.1, scheduled_queue.cc).
    """

    def __init__(self, partition_bytes: int, num_servers: int):
        self._partition_bytes = partition_bytes
        self._num_servers = num_servers
        self._entries: List[TensorEntry] = []
        self._by_name = {}

    def declare(self, name: str, shape: Sequence[int], dtype: str) -> TensorEntry:
        if name in self._by_name:
            entry = self._by_name[name]
            if entry.shape != tuple(shape) or entry.dtype != str(dtype):
                raise ValueError(
                    f"tensor {name!r} re-declared with different shape/dtype")
            return entry
        tensor_id = len(self._entries)
        entry = partition_tensor(
            tensor_id, name, shape, dtype,
            partition_bytes=self._partition_bytes,
            num_servers=self._num_servers,
            priority=-tensor_id,
        )
        self._entries.append(entry)
        self._by_name[name] = entry
        return entry

    def get(self, name: str) -> TensorEntry:
        return self._by_name[name]

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> Sequence[TensorEntry]:
        return tuple(self._entries)
