"""Live terminal monitor for streaming draws (``exmc_tpu/viz.py``):
zero dependencies, ANSI redraw, unicode sparklines, a running split
R-hat.

Usage (the chunk-granularity ``sample_stream`` consumer):

    from exmc_tpu_torch import sample_stream
    from exmc_tpu_torch.viz import LiveMonitor

    mon = LiveMonitor(num_chains=64, total_draws=1000)
    trace, stats = sample_stream(ir, mon, num_chains=64, chunk_size=100)
    print(mon.render_summary())

Every chunk updates per-parameter running moments, the split R-hat of
the draws accumulated so far, the divergence count, and a sparkline of
the cross-chain mean's trajectory.

Memory is bounded regardless of stream length: per displayed row the
monitor keeps per-chain Welford moments in 8 draw-index segments (fixed
boundaries at total_draws/8 — a segmented split-R-hat construction, so
a running R-hat is available from ~1/8 of the stream onward and
sharpens as segments fill), never the draws themselves, and the
sparkline path decimates by pairwise averaging once it exceeds its
resolution budget. The strings are the JAX package's, character for
character.

Also exposes ``sparkline(values)`` for ad-hoc use.
"""

import sys

import numpy as np

_BARS = "▁▂▃▄▅▆▇█"


def sparkline(values, width=28):
    """Unicode sparkline of a 1-d sequence, resampled to ``width``."""
    v = np.asarray(values, np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return " " * width
    if v.size > width:
        edges = np.linspace(0, v.size, width + 1).astype(int)
        v = np.array([v[a:b].mean() if b > a else v[min(a, v.size - 1)]
                      for a, b in zip(edges[:-1], edges[1:])])
    lo, hi = float(v.min()), float(v.max())
    span = hi - lo
    if span <= 0:
        return _BARS[0] * len(v) + " " * (width - len(v))
    idx = ((v - lo) / span * (len(_BARS) - 1)).round().astype(int)
    s = "".join(_BARS[i] for i in idx)
    return s + " " * (width - len(s))


class _SegMoments:
    """Per-chain Welford accumulator for one draw-index segment:
    count, mean, M2, each shape (chains,)."""

    def __init__(self, chains):
        self.n = 0
        self.mean = np.zeros(chains)
        self.m2 = np.zeros(chains)

    def update(self, cols):
        """cols: (chains, k) new draws — merged as one chunk via Chan's
        parallel-Welford combine (vectorized; no per-draw Python loop
        on the streaming hot path)."""
        k = cols.shape[1]
        if k == 0:
            return
        c_mean = cols.mean(axis=1)
        c_m2 = ((cols - c_mean[:, None]) ** 2).sum(axis=1)
        n_new = self.n + k
        delta = c_mean - self.mean
        self.m2 = self.m2 + c_m2 + delta**2 * (self.n * k / n_new)
        self.mean = self.mean + delta * (k / n_new)
        self.n = n_new

    def var(self):
        return self.m2 / max(self.n - 1, 1)


class LiveMonitor:
    """``sample_stream`` chunk consumer that renders a live dashboard.

    Parameters
    ----------
    num_chains, total_draws : run geometry (``total_draws`` also fixes
        the split point for the running split R-hat).
    params : optional list of trace keys to display (default: all,
        scalar-expanded, capped at ``max_rows``).
    stream : file-like to render into (default ``sys.stderr``).
    ansi : redraw in place with ANSI cursor movement (default: only
        when the stream is a TTY). With ``ansi=False`` each update
        appends a full frame — the mode tests use.
    max_rows : parameter-row cap (vector params expand to ``name[i]``).
    """

    def __init__(self, num_chains, total_draws, params=None, stream=None,
                 ansi=None, max_rows=8, spark_width=28):
        self.num_chains = num_chains
        self.total_draws = total_draws
        self.params = params
        self.stream = stream if stream is not None else sys.stderr
        self.ansi = (self.stream.isatty()
                     if ansi is None and hasattr(self.stream, "isatty")
                     else bool(ansi))
        self.max_rows = max_rows
        self.spark_width = spark_width
        self.n_segments = 8
        self._segs = {}           # (name, idx) -> [_SegMoments] * n_segments
        self._mean_path = {}      # (name, idx) -> per-chunk means (bounded)
        self._divergences = 0
        self._seen = 0
        self._frame_lines = 0
        self._t0 = None
        self._rate_base = None    # draws already produced when _t0 stamped

    # -- the sample_stream callback protocol ---------------------------
    def __call__(self, start_index, trace_chunk, stats_chunk):
        import time

        names = self._select(trace_chunk)
        seg_len = max(self.total_draws // self.n_segments, 1)
        k = None
        for name, idx in names:
            arr = np.asarray(trace_chunk[name], np.float64)
            col = arr if arr.ndim == 2 else arr.reshape(
                arr.shape[0], arr.shape[1], -1)[:, :, idx]
            segs = self._segs.setdefault(
                (name, idx),
                [_SegMoments(col.shape[0])
                 for _ in range(self.n_segments)])
            # route draw-index ranges to their fixed segments
            lo = 0
            while lo < col.shape[1]:
                seg = min((start_index + lo) // seg_len,
                          self.n_segments - 1)
                seg_end = ((seg + 1) * seg_len if seg < self.n_segments - 1
                           else self.total_draws)
                hi = min(col.shape[1], max(seg_end - start_index, lo + 1))
                segs[seg].update(col[:, lo:hi])
                lo = hi
            path = self._mean_path.setdefault((name, idx), [])
            path.append(float(col.mean()))
            if len(path) > 16 * self.spark_width:
                # pairwise decimation keeps the trajectory SHAPE at
                # bounded memory on arbitrarily long streams; an odd
                # tail element is kept, never dropped
                half = [(path[i] + path[i + 1]) / 2
                        for i in range(0, len(path) - 1, 2)]
                if len(path) % 2:
                    half.append(path[-1])
                self._mean_path[(name, idx)] = half
            k = col.shape[1]
        if k:
            self._seen = start_index + k
        if self._t0 is None:
            # stamp time at the END of the first chunk: its draws were
            # produced before the monitor had a clock, so they are the
            # rate baseline, not part of the measured production
            self._t0 = time.time()
            self._rate_base = self._seen
        div = stats_chunk.get("diverging")
        if div is not None:
            self._divergences += int(np.asarray(div).sum())
        self._render()

    # ------------------------------------------------------------------
    def _select(self, trace_chunk):
        out = []
        keys = self.params or list(trace_chunk)
        for name in keys:
            arr = np.asarray(trace_chunk[name])
            n_comp = 1 if arr.ndim == 2 else int(
                np.prod(arr.shape[2:], dtype=int))
            for i in range(n_comp):
                out.append((name, i))
                if len(out) >= self.max_rows:
                    return out
        return out

    def _row_stats(self, segs):
        """(mean, sd, segmented split-R-hat) from the per-chain segment
        moments — no draws retained. R-hat uses every segment with
        >= 2 draws (chains x filled-segments groups), so it is
        available from ~1/8 of the stream and sharpens as segments
        fill."""
        filled = [h for h in segs if h.n >= 2]
        n_tot = sum(h.n for h in segs)
        if n_tot == 0:
            return float("nan"), float("nan"), float("nan")
        # overall per-chain moments by chained Chan combination
        tot_n, tot_mean = 0, None
        tot_m2 = None
        for h in segs:
            if h.n == 0:
                continue
            if tot_mean is None:
                tot_n, tot_mean, tot_m2 = h.n, h.mean.copy(), h.m2.copy()
                continue
            n_new = tot_n + h.n
            delta = h.mean - tot_mean
            tot_m2 = tot_m2 + h.m2 + delta**2 * (tot_n * h.n / n_new)
            tot_mean = tot_mean + delta * (h.n / n_new)
            tot_n = n_new
        mean = float(tot_mean.mean())
        sd = float(np.sqrt(max(
            (tot_m2.sum() / max(n_tot * len(tot_mean) - 1, 1))
            + tot_mean.var(), 0.0)))
        if len(filled) < 2:
            return mean, sd, float("nan")
        # split R-hat over (filled segments x chains) groups; segment
        # lengths may differ at chunk boundaries — mean length
        # (monitor-grade)
        g_means = np.concatenate([h.mean for h in filled])
        g_vars = np.concatenate([h.var() for h in filled])
        n_bar = np.mean([h.n for h in filled])
        w = float(g_vars.mean())
        b = n_bar * float(g_means.var(ddof=1))
        var_plus = (n_bar - 1) / n_bar * w + b / n_bar
        return mean, sd, float(np.sqrt(var_plus / max(w, 1e-30)))

    def _label(self, name, idx, multi):
        return f"{name}[{idx}]" if multi else name

    def _comp_count(self):
        out = {}
        for (name, idx) in self._segs:
            out[name] = out.get(name, 0) + 1
        return out

    def _render(self):
        import time

        lines = []
        elapsed = max(time.time() - self._t0, 1e-9)
        produced = max(self._seen - self._rate_base, 0) * self.num_chains
        rate = produced / elapsed
        rate_s = f"{rate:,.0f} draws/s" if produced else "-- draws/s"
        lines.append(
            f"exmc_tpu live │ draw {self._seen}/{self.total_draws} "
            f"│ {self.num_chains} chains │ "
            f"{rate_s} │ divergences {self._divergences}"
        )
        comp_count = self._comp_count()
        for (name, idx), segs in self._segs.items():
            label = self._label(name, idx, comp_count[name] > 1)
            mean, sd, rhat = self._row_stats(segs)
            rh = f"{rhat:6.3f}" if np.isfinite(rhat) else "   -- "
            lines.append(
                f"  {label:<12.12} {mean:9.3f} ±{sd:7.3f}  "
                f"R-hat {rh}  "
                f"{sparkline(self._mean_path[(name, idx)], self.spark_width)}"
            )
        frame = "\n".join(lines)
        if self.ansi and self._frame_lines:
            self.stream.write(f"\x1b[{self._frame_lines}F\x1b[J")
        self.stream.write(frame + "\n")
        if hasattr(self.stream, "flush"):
            self.stream.flush()
        self._frame_lines = len(lines)

    def render_summary(self):
        """Final one-shot summary string (no ANSI)."""
        lines = [f"streamed {self._seen} draws x {self.num_chains} "
                 f"chains, divergences {self._divergences}"]
        comp_count = self._comp_count()
        for (name, idx), segs in self._segs.items():
            label = self._label(name, idx, comp_count[name] > 1)
            mean, sd, rhat = self._row_stats(segs)
            rh = f"{rhat:6.3f}" if np.isfinite(rhat) else "    --"
            lines.append(
                f"  {label:<12.12} mean {mean:9.3f}  sd {sd:8.3f}"
                f"  R-hat {rh}"
            )
        return "\n".join(lines)
