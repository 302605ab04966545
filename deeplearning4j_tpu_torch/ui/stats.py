"""StatsListener + StatsStorage (reference deeplearning4j-ui-model).

Reference: `StatsListener.java` (scores, param/update histograms and norms,
update:param ratios, memory, timing per iteration), `InMemoryStatsStorage`,
MapDB-backed `FileStatsStorage`, `RemoteUIStatsStorageRouter`.

Counterpart of ``deeplearning4j_tpu/ui/stats.py``: the same storages and
records (the same keys). The listener works out each update's norms, mean
magnitudes, histograms and update ratio on the parameters' device and
brings them to the host in one copy per update; the backend, device count
and memory come from ``torch.cuda`` (``memory_allocated`` and
``max_memory_allocated`` under the JAX record's ``bytes_in_use`` and
``peak_bytes_in_use``). Attaching it makes ``fit`` take its per-step path,
as any listener overriding ``iteration_done`` does.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class BaseStatsStorage:
    """StatsStorage API (reference org/deeplearning4j/api/storage)."""

    def put_static_info(self, session_id: str, info: Dict):
        raise NotImplementedError

    def put_update(self, session_id: str, record: Dict):
        raise NotImplementedError

    def list_session_ids(self) -> List[str]:
        raise NotImplementedError

    def get_static_info(self, session_id: str) -> Optional[Dict]:
        raise NotImplementedError

    def get_updates(self, session_id: str,
                    since_iteration: int = -1) -> List[Dict]:
        raise NotImplementedError

    def get_latest_update(self, session_id: str) -> Optional[Dict]:
        ups = self.get_updates(session_id)
        return ups[-1] if ups else None


class InMemoryStatsStorage(BaseStatsStorage):
    """Reference InMemoryStatsStorage."""

    def __init__(self):
        self._static: Dict[str, Dict] = {}
        self._updates: Dict[str, List[Dict]] = {}
        self._lock = threading.Lock()

    def put_static_info(self, session_id, info):
        with self._lock:
            self._static[session_id] = dict(info)
            self._updates.setdefault(session_id, [])

    def put_update(self, session_id, record):
        with self._lock:
            self._updates.setdefault(session_id, []).append(dict(record))

    def list_session_ids(self):
        with self._lock:
            return sorted(set(self._static) | set(self._updates))

    def get_static_info(self, session_id):
        with self._lock:
            return self._static.get(session_id)

    def get_updates(self, session_id, since_iteration=-1):
        with self._lock:
            ups = list(self._updates.get(session_id, []))
        return [u for u in ups if u.get("iteration", 0) > since_iteration]


class FileStatsStorage(BaseStatsStorage):
    """JSONL-file-backed storage (reference FileStatsStorage, minus MapDB):
    append-only updates file + static-info sidecar, reload-safe."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self._lock = threading.Lock()
        self._mem = InMemoryStatsStorage()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    rec = json.loads(line)
                    if rec["kind"] == "static":
                        self._mem.put_static_info(rec["session"],
                                                  rec["data"])
                    else:
                        self._mem.put_update(rec["session"], rec["data"])

    def _append(self, kind, session_id, data):
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps({"kind": kind, "session": session_id,
                                    "data": data}) + "\n")

    def put_static_info(self, session_id, info):
        self._mem.put_static_info(session_id, info)
        self._append("static", session_id, info)

    def put_update(self, session_id, record):
        self._mem.put_update(session_id, record)
        self._append("update", session_id, record)

    def list_session_ids(self):
        return self._mem.list_session_ids()

    def get_static_info(self, session_id):
        return self._mem.get_static_info(session_id)

    def get_updates(self, session_id, since_iteration=-1):
        return self._mem.get_updates(session_id, since_iteration)


class RemoteUIStatsStorageRouter(BaseStatsStorage):
    """POST records to a remote UIServer (reference
    RemoteUIStatsStorageRouter)."""

    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def _post(self, endpoint: str, payload: Dict):
        import urllib.request
        req = urllib.request.Request(
            self.url + endpoint, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.read()

    def put_static_info(self, session_id, info):
        self._post("/remote/static", {"session": session_id, "data": info})

    def put_update(self, session_id, record):
        self._post("/remote/update", {"session": session_id, "data": record})

    def list_session_ids(self):
        return []

    def get_static_info(self, session_id):
        return None

    def get_updates(self, session_id, since_iteration=-1):
        return []


_BINS = 20


def _edges(lo: float, hi: float, bins: int = _BINS) -> List[float]:
    """``np.histogram``'s bin edges over ``[lo, hi]`` (a range of one
    value widened by 0.5 each side, as numpy does)."""
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return [float(e) for e in np.linspace(lo, hi, bins + 1)]


def _on_host(model) -> bool:
    dev = getattr(model, "device", None)
    return dev is None or torch.device(dev).type != "cuda"


class StatsListener:
    """Per-iteration training stats collector (reference StatsListener).

    Attach to MultiLayerNetwork/ComputationGraph via `add_listener` /
    `_listeners`. Collects: score, per-layer param/gradient L2 norms and
    mean magnitudes, update:param ratios, histograms (every
    `histogram_frequency` iters), timing, device memory. The statistics
    are reductions on the parameters' device, packed into one vector that
    crosses to the host in one copy per update.
    """

    def __init__(self, storage: BaseStatsStorage, session_id: str = None,
                 update_frequency: int = 1, histogram_frequency: int = 10):
        self.storage = storage
        self.session_id = session_id or f"session_{int(time.time())}"
        self.update_frequency = update_frequency
        self.histogram_frequency = histogram_frequency
        self._static_sent = False
        self._last_time = None
        self._prev_flat: Optional[torch.Tensor] = None

    def _send_static(self, model):
        info = {
            "model_class": type(model).__name__,
            "n_layers": len(getattr(model, "layers", [])) or
            len(getattr(model, "_order", [])),
            "n_params": int(model.num_params())
            if hasattr(model, "num_params") else 0,
            "start_time": time.time(),
        }
        if _on_host(model):
            info["backend"], info["device_count"] = "cpu", 1
        else:
            info["backend"] = "cuda"
            info["device_count"] = torch.cuda.device_count()
        self.storage.put_static_info(self.session_id, info)
        self._static_sent = True

    def _param_items(self, model):
        params = getattr(model, "_params", None)
        if isinstance(params, dict):
            for name, p in params.items():
                for k, v in p.items():
                    yield f"{name}/{k}", v
        elif isinstance(params, list):
            for i, p in enumerate(params):
                for k, v in p.items():
                    yield f"layer{i}/{k}", v

    def iteration_done(self, model, iteration, loss=None):
        if iteration % self.update_frequency != 0:
            return
        if not self._static_sent:
            self._send_static(model)
        now = time.time()
        dt = (now - self._last_time) if self._last_time else None
        self._last_time = now

        with_hist = iteration % self.histogram_frequency == 0
        leaves = [(name, v.detach()) for name, v in self._param_items(model)
                  if not name.split("/")[-1].startswith("state_")]
        # one device vector: per leaf [l2, mean |a|] (+ [min, max, counts]
        # with histograms), then [|flat - prev|, |prev|], then the loss
        parts: List[torch.Tensor] = []
        for _, v in leaves:
            a = v.reshape(-1).float()
            if a.numel() == 0:
                continue
            parts.append(torch.stack([torch.linalg.vector_norm(a),
                                      a.abs().mean()]))
            if with_hist:
                parts.append(torch.stack([a.min(), a.max()]))
                parts.append(torch.histc(a, bins=_BINS))
        flat = torch.cat([v.reshape(-1).float() for _, v in leaves]) \
            if leaves else None
        has_ratio = flat is not None and self._prev_flat is not None \
            and self._prev_flat.shape == flat.shape
        if has_ratio:
            parts.append(torch.stack([
                torch.linalg.vector_norm(flat - self._prev_flat),
                torch.linalg.vector_norm(self._prev_flat)]))
        if flat is not None:
            self._prev_flat = flat
        score = loss
        if isinstance(loss, torch.Tensor):
            parts.append(loss.detach().float().reshape(1))
        host = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy() \
            if parts else np.zeros(0, np.float32)
        if isinstance(loss, torch.Tensor):
            score, host = host[-1], host[:-1]

        record: Dict[str, Any] = {
            "iteration": int(iteration),
            "time": now,
            "score": float(score) if score is not None else
            float(getattr(model, "score_value", float("nan"))),
            "iter_seconds": dt,
        }
        param_stats = {}
        i = 0
        for name, v in leaves:
            if v.numel() == 0:
                s = {"l2": 0.0, "mean_mag": float("nan")}
                if with_hist:
                    s["histogram"] = {"counts": [], "edges": []}
                param_stats[name] = s
                continue
            s = {"l2": float(host[i]), "mean_mag": float(host[i + 1])}
            i += 2
            if with_hist:
                lo, hi = float(host[i]), float(host[i + 1])
                counts = host[i + 2:i + 2 + _BINS]
                i += 2 + _BINS
                s["histogram"] = {"counts": [int(c) for c in counts],
                                  "edges": _edges(lo, hi)}
            param_stats[name] = s
        record["params"] = param_stats
        if has_ratio:
            upd, p_norm = float(host[i]), float(host[i + 1])
            record["update_param_ratio"] = upd / max(p_norm, 1e-12)
        if not _on_host(model):
            dev = torch.device(model.device)
            record["memory"] = {
                "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
                "peak_bytes_in_use": int(
                    torch.cuda.max_memory_allocated(dev)),
            }
        self.storage.put_update(self.session_id, record)

    def on_epoch_end(self, epoch, model):
        pass
