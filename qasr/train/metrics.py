"""Structured metric writer: console + JSONL (+ CSV), host-0 only.

Reference capability: console progress + CSV epoch logging (SURVEY.md §5
"Metrics / logging"). Adds step time and audio-seconds/s/chip — the
north-star throughput metric (BASELINE.json).
"""

from __future__ import annotations

import json
import os
import time

import jax


def per_device_bytes(tree) -> dict:
    """Bytes of this pytree each local device actually holds (sharding-aware:
    a TP-sharded kernel counts 1/n_shards per device, replicated leaves count
    full size on every device). The evidence that tensor parallelism is
    really dividing memory — SURVEY.md §2c P2."""
    out: dict = {}
    for leaf in jax.tree_util.tree_leaves(tree):
        shards = getattr(leaf, "addressable_shards", None)
        if shards is None:
            continue
        for sh in shards:
            key = str(sh.device)
            out[key] = out.get(key, 0) + sh.data.nbytes
    return out


def device_memory_stats() -> dict:
    """Per-device allocator stats (bytes_in_use / limit) where the backend
    exposes them (GPU does; CPU returns {})."""
    out = {}
    for d in jax.local_devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats:
            out[str(d)] = {
                "bytes_in_use": int(stats.get("bytes_in_use", 0)),
                "bytes_limit": int(stats.get("bytes_limit", 0)),
            }
    return out


class MetricWriter:
    def __init__(self, out_dir: str | None = None, console: bool = True):
        self.console = console
        self.jsonl = None
        if out_dir and jax.process_index() == 0:
            os.makedirs(out_dir, exist_ok=True)
            self.jsonl = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self._t_last = time.perf_counter()

    def write(self, step: int, metrics: dict):
        now = time.perf_counter()
        rec = {"step": step, "time": now}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v
        rec["step_time_s"] = now - self._t_last
        self._t_last = now
        if self.jsonl:
            self.jsonl.write(json.dumps(rec) + "\n")
            self.jsonl.flush()
        if self.console and jax.process_index() == 0:
            shown = {
                k: (f"{v:.4g}" if isinstance(v, float) else v)
                for k, v in rec.items()
                if k not in ("time",)
            }
            print(f"[qasr] {shown}", flush=True)

    def close(self):
        if self.jsonl:
            self.jsonl.close()
