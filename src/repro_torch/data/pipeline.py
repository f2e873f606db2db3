"""Deterministic, resumable, host-sharded data pipeline — a copy of
``repro.data.pipeline`` for the port (numpy only: batches are equal
element for element, the modality inputs included).

Design for 1000+-node training:

* **Stateless indexing** — batch ``i`` is a pure function of ``(seed, i)``;
  there is no iterator state to checkpoint.  Restart/elastic-reshard resume
  is "set step counter, continue" — the pipeline itself needs nothing saved.
* **Host sharding** — each host materializes only its slice of the global
  batch (``host_id / num_hosts``); `global_batch` stays the logical unit so
  the same config runs on any number of hosts.
* **Synthetic + file-backed sources** — the synthetic source generates a
  deterministic "language-like" token stream (Zipfian unigram + a repeated
  n-gram process so the loss actually decreases); the file source
  memory-maps a flat uint16/uint32 token file and windows into it.  Both
  share the stateless index contract.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab: int = 1024
    seed: int = 0
    source: str = "synthetic"       # synthetic | file:<path>
    # modality stubs (the frontends are stubs: precomputed embeddings)
    vision_seq: int = 0             # patch rows a batch row (vlm)
    frames: int = 0                 # frame rows a batch row (encdec)
    d_model: int = 0


def _host_slice(cfg: DataConfig, host_id: int, num_hosts: int):
    assert cfg.global_batch % num_hosts == 0, (cfg.global_batch, num_hosts)
    per = cfg.global_batch // num_hosts
    return host_id * per, per


class SyntheticSource:
    """Deterministic language-like stream: Zipf unigrams + copied spans.

    Each (step, row) seeds an independent Philox stream -> reproducible
    regardless of host layout, restart point, or batch parallelism.
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._probs = p / p.sum()

    def row(self, step: int, row_idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row_idx]))
        toks = rng.choice(cfg.vocab, size=cfg.seq_len, p=self._probs)
        # plant copied spans -> learnable induction structure
        n_spans = max(1, cfg.seq_len // 256)
        for _ in range(n_spans):
            ln = int(rng.integers(8, 32))
            if 2 * ln + 2 >= cfg.seq_len:
                continue
            src = int(rng.integers(0, cfg.seq_len - 2 * ln - 1))
            dst = int(rng.integers(src + ln, cfg.seq_len - ln))
            toks[dst:dst + ln] = toks[src:src + ln]
        return toks.astype(np.int32)


class FileSource:
    """Flat binary token file; batch rows are strided windows."""

    def __init__(self, cfg: DataConfig, path: str):
        self.cfg = cfg
        self._data = np.memmap(path, dtype=np.uint16, mode="r")
        self._n_windows = (len(self._data) - 1) // cfg.seq_len

    def row(self, step: int, row_idx: int) -> np.ndarray:
        cfg = self.cfg
        # deterministic shuffle via multiplicative hashing over windows
        i = (step * cfg.global_batch + row_idx)
        w = (i * 2654435761) % self._n_windows
        start = w * cfg.seq_len
        return np.asarray(self._data[start:start + cfg.seq_len],
                          dtype=np.int32) % cfg.vocab


def make_source(cfg: DataConfig):
    if cfg.source == "synthetic":
        return SyntheticSource(cfg)
    if cfg.source.startswith("file:"):
        return FileSource(cfg, cfg.source[5:])
    raise ValueError(f"unknown data source {cfg.source!r}")


class Pipeline:
    """``batch_at(step)`` -> host-local batch dict of numpy arrays."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        self.cfg = cfg
        self.host_id, self.num_hosts = host_id, num_hosts
        self.source = make_source(cfg)
        self._start, self._per_host = _host_slice(cfg, host_id, num_hosts)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """``tokens`` (rows, seq_len) int32; with ``vision_seq`` also
        ``image_embeds`` and with ``frames`` also ``frames`` (rows, n,
        d_model) f32, N(0, 1) from their own streams of ``(seed, step)``
        (one draw for the host's rows, as the reference's)."""
        cfg = self.cfg
        rows = [self.source.row(step, self._start + r)
                for r in range(self._per_host)]
        batch = {"tokens": np.stack(rows)}
        for key, n, stream in (("image_embeds", cfg.vision_seq, 1 << 20),
                               ("frames", cfg.frames, 1 << 21)):
            if n:
                rng = np.random.default_rng(
                    np.random.SeedSequence([cfg.seed, step, stream]))
                batch[key] = rng.standard_normal(
                    (self._per_host, n, cfg.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
