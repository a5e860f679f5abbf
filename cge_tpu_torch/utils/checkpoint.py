"""Checkpoint and resume for scene optimisation loops (counterpart of
cge_tpu/utils/checkpoint.py:21-60).

A checkpoint is a directory `step_<N>` under the run's directory holding
`tree.pt`, the torch.save of a tree of dicts, lists and tensors (for
example diff.gradients.scene_params(scene) and any optimiser state). It is
written under a temporary name and renamed, so a `step_<N>` that exists is
complete. It loads with weights_only=True: tensors and plain containers,
no pickled code.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional

import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_FILE = "tree.pt"


def save(directory: str, step: int, tree: Any) -> str:
    """Write `tree` as checkpoint step_<step> under `directory`; returns
    the checkpoint's path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tree, os.path.join(tmp, _FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The highest step with a checkpoint in `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def restore(directory: str, step: Optional[int] = None,
            device=None) -> Any:
    """Load checkpoint `step` (the latest by default), its tensors on
    `device` (where they were saved when None)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step}", _FILE)
    return torch.load(path, weights_only=True, map_location=device)
