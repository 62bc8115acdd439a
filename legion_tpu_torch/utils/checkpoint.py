"""Checkpoint and resume (counterpart of ``legion_tpu/utils/checkpoint.py``,
with ``torch.save`` in place of Orbax).

What is saved is what the JAX package saves (``_SAVED_KEYS``): the model's
parameters, Adam's state, the three schedule counters and the base key,
everything that fixes the rest of a run. The step keys are a pure function
of (base key, counter, tag) (``Trainer.step_key``, K10), and so is every
dropout mask (drawn from K10's dropout key), so no generator state is
saved. The position map, the eval accumulators and the ``interbatch``
carry are scratch (the map is clean between batches; the carry is the
batch at ``train_ctr``, sampled again after a restore) and come fresh
from ``init_state``. ``train_ctr`` counts trained batches in both modes,
so a checkpoint written under ``interbatch`` restores into a plain
trainer, and the reverse.

One file a step, ``<path>/ckpt_<step>.pt``, written under a temporary name
and then renamed over, so a crash never leaves a partial checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Dict

import torch

_SAVED_KEYS = ("model", "opt", "train_ctr", "valid_ctr", "test_ctr",
               "base_key")
_COUNTERS = ("train_ctr", "valid_ctr", "test_ctr")
_NAME = re.compile(r"ckpt_(\d+)\.pt$")


def _file(path: str, step: int) -> str:
    return os.path.join(path, f"ckpt_{step:010d}.pt")


def save_checkpoint(path: str, state: Dict, step: int) -> None:
    """Write the checkpoint of ``state`` (a Trainer state dict) at
    ``step``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {"model": state["model"].state_dict(),
               "opt": state["opt"].state_dict(),
               "base_key": int(state["base_key"])}
    for k in _COUNTERS:
        payload[k] = int(state[k])
    dst = _file(path, step)
    tmp = f"{dst}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, dst)


def latest_step(path: str) -> int:
    """The largest step saved under ``path``; -1 when there is none."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return -1
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
             if m]
    return max(steps, default=-1)


def restore_checkpoint(path: str, trainer, step: int = -1) -> Dict:
    """A fresh state of ``trainer`` (``init_state``) with the saved keys
    of the checkpoint at ``step`` (the latest when negative); every other
    state of the trainer is left as it was.

    The parameters are loaded in place into the new state's own module;
    Adam keeps the trainer's ``capturable``, so its step counts come back
    on the parameters' device; each counter is set on the host and in its
    device twin (K10 reads the twin); the base key is set in the state
    (on the device) and as the trainer's ``step_key`` key; then the carry is primed at the restored
    ``train_ctr`` (``Trainer.prime_carry``: every member's batch; a no-op
    unless ``interbatch``), as ``legion_tpu/utils/checkpoint.py:57-59``
    does.
    The file is read onto the trainer's device, whatever device wrote
    it."""
    path = os.path.abspath(path)
    if step < 0:
        step = latest_step(path)
        if step < 0:
            raise FileNotFoundError(f"no checkpoints under {path}")
    state = trainer.init_state()
    ck = torch.load(_file(path, step), map_location=trainer.device,
                    weights_only=True)
    state["model"].load_state_dict(ck["model"])
    opt = state["opt"]
    saved = ck["opt"]
    for g_saved, g_now in zip(saved["param_groups"], opt.param_groups):
        g_saved["capturable"] = g_now["capturable"]
    opt.load_state_dict(saved)
    for k in _COUNTERS:
        state[k] = int(ck[k])
        state[k + "_d"].fill_(state[k])
    state["base_key"].fill_(ck["base_key"])
    trainer._base_key = int(ck["base_key"])
    return trainer.prime_carry(state)
