"""Checkpoint, resume and export with ``torch.save``.

Port of ``mikudance_tpu/train/checkpoint.py`` (orbax and msgpack there):

- the full training state at a cadence with last-3 retention and
  resume-from-newest: ``CheckpointManager``, ``save_state``, ``restore_state``
  (whole on disk whatever the ranks held, as ``jax.device_get(state)``);
- deployable per-component weights as plain ``state_dict`` files, including
  the stage-2 motion-module-only dict filtered by key substring:
  ``export_params``, ``import_params``, ``filter_by_substring``.

Files hold tensors, numbers and dicts only and are read back with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _write(obj, path: str) -> None:
    """``torch.save`` to a temporary name, then rename: an interrupted save
    never leaves a partial file under the final name."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(obj), tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """``step_<n>.pt`` files in one directory, the newest ``keep`` retained."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory, self.keep = os.path.abspath(directory), keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        found = (_STEP_FILE.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree) -> None:
        _write(tree, self.path(step))
        for old in self.all_steps()[:-self.keep]:
            os.remove(self.path(old))

    def restore(self, step: int):
        return torch.load(self.path(step), map_location="cpu", weights_only=True)


def make_manager(directory: str, keep: int = 3) -> CheckpointManager:
    return CheckpointManager(directory, keep)


def save_state(mgr: CheckpointManager, step: int, state, write: bool = True) -> None:
    """The whole ``TrainState``: both modules, the optimizer, the step count.
    A ZeRO optimizer's state is gathered whole to the first rank of its
    'data' axis first, so every rank of its mesh calls this; only the one
    with ``write``, which must be that first rank, writes the file."""
    optimizer = state.optimizer.state_dict()
    if write:
        if optimizer is None:
            raise ValueError("under ZeRO only the first rank of the 'data' axis holds the "
                             "whole optimizer state: write from that rank")
        mgr.save(step, {"guide": state.guide.state_dict(), "den": state.den.state_dict(),
                        "optimizer": optimizer, "step": state.step})


def restore_state(mgr: CheckpointManager, state) -> Tuple[object, int]:
    """Load the newest checkpoint into ``state`` (in place); returns the state
    and the checkpoint's step, 0 where there is none. The file holds the
    whole state; a ZeRO optimizer keeps its shards of it, so a checkpoint of
    one rank and one of n ranks resume each other."""
    step = mgr.latest_step()
    if step is None:
        return state, 0
    tree = mgr.restore(step)
    state.guide.load_state_dict(tree["guide"], strict=True)
    state.den.load_state_dict(tree["den"], strict=True)
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    return state, int(step)


# ------------------------------------------------------------------ export

def export_params(params: Mapping[str, torch.Tensor], path: str) -> None:
    _write(dict(params), path)


def import_params(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def filter_by_substring(params: Mapping[str, torch.Tensor], substrings) -> Dict[str, torch.Tensor]:
    """The entries whose key contains any substring (the stage-2
    motion-module-only deployable dict)."""
    return {k: v for k, v in params.items() if any(s in k for s in substrings)}
