"""Atomic, integrity-checked checkpoints with async save and fall-back.

The contract of ``src/repro/checkpoint/manager.py``, on a flat dict of
tensors (name -> tensor: a model's parameters and its optimizer state):

* writes go to ``<dir>/tmp.<step>`` and are renamed to ``ckpt_<step:08d>``,
  so a crash during a save never corrupts the latest checkpoint;
* the manifest holds the step, the caller's metadata and, per leaf, its
  name, shape, dtype and the CRC-32 of its bytes; ``restore`` checks them
  and falls back to the previous valid checkpoint on a mismatch;
* ``save_async`` copies the leaves to host memory before it returns and
  writes them from a thread; ``wait`` joins it;
* ``keep`` bounds the number of checkpoints kept.

The arrays go to one ``arrays.npz``.  bfloat16, which numpy lacks, is
stored as its 16-bit patterns (``int16``) under the dtype name
``bfloat16``, so it round-trips bit for bit.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zipfile
import zlib

import numpy as np
import torch

_BITS = {torch.bfloat16: torch.int16}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype in _BITS:
        t = t.view(_BITS[t.dtype])
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[-1]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: dict, metadata: dict | None = None):
        self.wait()
        self._save_sync(step, self._to_host(tree), metadata or {})

    def save_async(self, step: int, tree: dict, metadata: dict | None = None):
        self.wait()
        host = self._to_host(tree)  # the snapshot, taken before returning
        self._thread = threading.Thread(
            target=self._save_sync, args=(step, host, metadata or {}), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @staticmethod
    def _to_host(tree: dict) -> dict:
        """name -> (numpy array, dtype name)."""
        return {name: (_to_numpy(t), _dtype_name(t)) for name, t in tree.items()}

    def _save_sync(self, step: int, host: dict, metadata: dict):
        tmp = self.dir / f"tmp.{step}"
        final = self.dir / f"ckpt_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "metadata": metadata, "leaves": []}
        arrays = {}
        for i, (name, (arr, dtype)) in enumerate(host.items()):
            arrays[f"leaf_{i}"] = arr
            manifest["leaves"].append({
                "key": f"leaf_{i}", "name": name, "shape": list(arr.shape), "dtype": dtype,
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            })
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # the atomic publish
        self._gc()

    def _gc(self):
        for s in self.steps()[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"ckpt_{s:08d}", ignore_errors=True)

    # -- read -----------------------------------------------------------------

    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("ckpt_*"))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like: dict, step: int | None = None):
        """Restore the leaves named in ``like`` (name -> tensor), each to its
        like's device, shape and dtype.

        Checks every CRC, shape and dtype; on a mismatch falls back to the
        next older checkpoint.  Returns (dict, step, metadata), or None when
        no checkpoint is valid.
        """
        self.wait()
        candidates = self.steps()
        if step is not None:
            candidates = [s for s in candidates if s == step]
        for s in reversed(candidates):
            try:
                return self._restore_one(like, s)
            except (ValueError, OSError, KeyError, zipfile.BadZipFile) as e:  # corrupt -> older
                print(f"checkpoint {s} invalid ({e}); trying older")
        return None

    def _restore_one(self, like: dict, step: int):
        path = self.dir / f"ckpt_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        leaves = {leaf["name"]: leaf for leaf in manifest["leaves"]}
        missing = sorted(set(like) - set(leaves))
        if missing:
            raise ValueError(f"{len(missing)} leaves missing, e.g. {missing[:3]}")
        out = {}
        with np.load(path / "arrays.npz") as data:
            for name, want in like.items():
                meta = leaves[name]
                arr = data[meta["key"]]
                if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc"]:
                    raise ValueError(f"CRC mismatch on {name}")
                if tuple(arr.shape) != tuple(want.shape) or meta["dtype"] != _dtype_name(want):
                    raise ValueError(f"{name}: {meta['dtype']} {tuple(arr.shape)} in the "
                                     f"checkpoint, {want.dtype} {tuple(want.shape)} wanted")
                t = torch.from_numpy(np.array(arr))
                if want.dtype in _BITS:
                    t = t.view(want.dtype)
                out[name] = t.to(want.device)
        return out, manifest["step"], manifest["metadata"]
