"""Disk-backed streaming trace store (``exmc_tpu/utils/trace_store.py``).

Runs whose draws exceed host memory stream chunks straight to disk:
plug ``TraceStore.as_callback()`` into ``sample_stream`` /
``run_chunked(callback=...)`` and each post-warmup chunk lands in its
own compressed shard; nothing accumulates in RAM beyond one chunk.

Storage layout (one directory per run), the JAX package's, so either
package reads the other's stores:
    meta.json                run metadata + chunk index
    chunk_00000.npz          trace_<name> + stat_<name> arrays

Reading is chunk-lazy: ``iter_chunks()`` yields shards in order;
``load(name)`` concatenates one variable across shards only when asked.
"""

import json
import os

import numpy as np


class TraceStore:
    def __init__(self, path, keep_in_memory=False):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        self.keep_in_memory = keep_in_memory
        self._index = []
        self._mem = []

    # ---- writing ----

    def append(self, start, trace_chunk, stats_chunk=None):
        """Persist one chunk ((chains, m, ...) arrays starting at sample
        index ``start``)."""
        i = len(self._index)
        fname = f"chunk_{i:05d}.npz"
        payload = {f"trace_{k}": np.asarray(v) for k, v in trace_chunk.items()}
        if stats_chunk:
            payload.update(
                {f"stat_{k}": np.asarray(v) for k, v in stats_chunk.items()}
            )
        np.savez_compressed(os.path.join(self.path, fname), **payload)
        n = next(iter(trace_chunk.values())).shape[1]
        self._index.append({"file": fname, "start": int(start), "n": int(n)})
        if self.keep_in_memory:
            self._mem.append((start, trace_chunk, stats_chunk))
        self._write_meta()

    def _write_meta(self):
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump({"chunks": self._index}, f)

    def as_callback(self):
        """Callback plugging into sample_stream / run_chunked."""

        def cb(start, trace_chunk, stats_chunk):
            self.append(start, trace_chunk, stats_chunk)

        return cb

    # ---- reading ----

    @classmethod
    def open(cls, path):
        store = cls(path)
        with open(os.path.join(str(path), "meta.json")) as f:
            store._index = json.load(f)["chunks"]
        return store

    @property
    def num_samples(self):
        return sum(c["n"] for c in self._index)

    def iter_chunks(self):
        """Yield (start, {trace}, {stats}) per shard — memory use is one
        chunk regardless of run length."""
        for c in self._index:
            with np.load(os.path.join(self.path, c["file"])) as z:
                trace = {
                    k[len("trace_"):]: z[k] for k in z.files
                    if k.startswith("trace_")
                }
                stats = {
                    k[len("stat_"):]: z[k] for k in z.files
                    if k.startswith("stat_")
                }
            yield c["start"], trace, stats

    def variables(self):
        if not self._index:
            return []
        with np.load(os.path.join(self.path, self._index[0]["file"])) as z:
            return sorted(
                k[len("trace_"):] for k in z.files if k.startswith("trace_")
            )

    def load(self, name, kind="trace"):
        """Concatenate one variable across all shards (chains, total, ...)."""
        parts = []
        prefix = "trace_" if kind == "trace" else "stat_"
        for c in self._index:
            with np.load(os.path.join(self.path, c["file"])) as z:
                parts.append(z[prefix + name])
        return np.concatenate(parts, axis=1)

    def running_mean(self, name):
        """Streaming posterior mean without materializing the trace."""
        total, count = 0.0, 0
        for _, trace, _ in self.iter_chunks():
            arr = np.asarray(trace[name], np.float64)
            total = total + arr.sum(axis=(0, 1))
            count += arr.shape[0] * arr.shape[1]
        return total / count
