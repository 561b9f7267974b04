"""Deterministic synthetic data pipeline with credit-bounded prefetch (the
port's counterpart of ``repro.data.pipeline``, numpy only: batch ``i``
equals the reference's array for array).

Production framing: each host process feeds the devices it owns; the global
batch is partitioned by (pod, data-row), matching the ``batch`` sharding
rule.  Prefetch depth follows the paper's credit rule (C3): in-flight
batches = bandwidth-delay product of the host->device path — we default to
2 credits (the classic double-buffer), configurable.

The generator is counter-based (stateless): batch ``i`` is a pure function
of (seed, i), so restart-after-failure resumes mid-epoch exactly (the
checkpoint stores only the step counter).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["DataConfig", "synthetic_batch", "batch_iterator", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    prefetch_credits: int = 2   # paper C3: BDP of host->device transfer
    pack_docs: bool = True      # pack multiple docs per row (mask at joins)
    mean_doc_len: int = 512


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
                    data_cfg: DataConfig = DataConfig(),
                    batch_override: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Batch ``step`` of the infinite deterministic stream.

    Emits a Zipf-distributed token stream with document packing: a weak
    long-range structure so losses move during the example runs (pure
    uniform tokens give flat loss immediately).
    """
    B = batch_override or shape.global_batch
    S = shape.seq_len
    rng = np.random.default_rng(
        np.random.SeedSequence([data_cfg.seed, step]))
    V = cfg.vocab_size
    # Zipf-ish unigram with per-document offset (documents are "topics")
    ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
    if data_cfg.pack_docs:
        n_docs = max(1, (S + 1) // data_cfg.mean_doc_len)
        starts = np.sort(rng.integers(1, S + 1, size=(B, n_docs)), axis=1)
        doc_id = np.zeros((B, S + 1), np.int64)
        for j in range(n_docs):
            doc_id += (np.arange(S + 1)[None] >= starts[:, j:j + 1])
        offset = rng.integers(0, V, size=(B, 1)) * 31 + doc_id * 977
    else:
        offset = rng.integers(0, V, size=(B, 1))
    tokens = ((ranks + offset) % V).astype(np.int32)
    batch = {
        "tokens": tokens[:, :-1],
        "labels": tokens[:, 1:],
        "mask": np.ones((B, S), np.float32),
    }
    if cfg.family == "audio":
        fr = rng.standard_normal(
            (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32) * 0.1
        batch["frames"] = fr
    if cfg.family == "vlm":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        batch["positions"] = np.broadcast_to(pos[None], (3, B, S)).copy()
    return batch


def batch_iterator(cfg: ModelConfig, shape: ShapeConfig,
                   start_step: int = 0,
                   data_cfg: DataConfig = DataConfig(),
                   batch_override: Optional[int] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, shape, step, data_cfg, batch_override)
        step += 1


class Prefetcher:
    """Credit-bounded background prefetch (paper C3 as a host-side queue).
    The thread yields numpy batches; the consumer copies them to the card
    on its own thread.

    The producer thread holds ``credits`` tokens; each produced batch
    consumes one, each consumed batch returns one — the queue can never
    grow beyond the credit count (no unbounded host memory), and a fence
    (``close``) drains it.
    """

    def __init__(self, it: Iterator, credits: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=credits)
        self._it = it
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._done.is_set():
                    return
                self._q.put(item)   # blocks when out of credits
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._done.set()
        while not self._q.empty():
            self._q.get_nowait()
