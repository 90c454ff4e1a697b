"""Checkpoints: the trainer's, in the upstream torch layout, and the JAX
package's `mesm_tpu.v1` pickles.

The reference saves {model, optimizer, lr_scheduler, epoch, opt} with
torch.save (reference train.py:185-223); the trainer writes that layout, so
`mesm_tpu_torch.evaluate` scores what it writes. The model state holds no
text encoder (it lives outside the model). Two keys the reference does not
write ride along for --resume_all: `step` (train steps taken, which seed the
draws of the next step) and `lr`.

`load_checkpoint` also reads the JAX package's own format
(mesm_tpu/utils/checkpoint.py:24-44: a pickle of {format: "mesm_tpu.v1",
model, optimizer, epoch, opt, lr} with numpy leaves), telling the two apart
by their leading bytes as mesm_tpu/evaluate.py:467 does. Its `optimizer`
entry is an optax state tree: the classes of optax, flax, jax and jaxlib in
it are read as `StubState` tuples that keep their fields (the port imports
none of those packages). convert.py maps the parameters and the AdamW
moments onto the port; `save_v1_checkpoint` writes the format back.
"""
from __future__ import annotations

import operator
import os
import pickle
from typing import Any, Dict, Optional

import torch

V1_FORMAT = "mesm_tpu.v1"

# the fields of the optax states a v1 checkpoint holds (optax.chain of
# clip_by_global_norm and inject_hyperparams(adamw), mesm_tpu/parallel/step.py:33-55)
_STATE_FIELDS = {
    "EmptyState": (),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "InjectHyperparamsState": ("count", "hyperparams", "inner_state"),
    "InjectStatefulHyperparamsState": ("count", "hyperparams", "hyperparams_states",
                                       "inner_state"),
}
_STUBBED_PACKAGES = ("optax", "flax", "jax", "jaxlib")


class StubState(tuple):
    """A class of optax, flax or jax read from a pickle without its package:
    the positional fields it was pickled with (a NamedTuple's), each also an
    attribute by name where `_STATE_FIELDS` knows the class."""

    def __new__(cls, *args):
        return tuple.__new__(cls, args)


class _V1Unpickler(pickle.Unpickler):
    def __init__(self, file):
        super().__init__(file)
        self._stubs: Dict[tuple, type] = {}

    def find_class(self, module, name):
        if module.split(".")[0] not in _STUBBED_PACKAGES:
            return super().find_class(module, name)
        if name == "FrozenDict":  # pickled as FrozenDict(dict): read as the dict
            return dict
        key = (module, name)
        if key not in self._stubs:
            fields = {f: property(operator.itemgetter(i))
                      for i, f in enumerate(_STATE_FIELDS.get(name, ()))}
            self._stubs[key] = type(name, (StubState,), dict(fields, __module__=module))
        return self._stubs[key]


def is_torch_checkpoint(path: str) -> bool:
    """The format from the leading bytes (mesm_tpu/evaluate.py:467
    _is_torch_ckpt): torch's zip archive ("PK") or legacy pickle ("\\x80\\x02"),
    else a v1 pickle, whose first pickled item is the string 'format'."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head.startswith(b"PK") or head.startswith(b"\x80\x02"):
        return True
    return b"format" not in head and b"mesm_tpu" not in head


def find_state(tree, name: str):
    """The first node of class `name` in a v1 optimizer tree, or None."""
    if type(tree).__name__ == name:
        return tree
    children = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for child in children:
        found = find_state(child, name)
        if found is not None:
            return found
    return None


def save_checkpoint(path: str, model, optimizer, epoch: int, opt: Dict, step: int, lr: float,
                    lr_drop: int, gamma: float) -> None:
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        # torch StepLR's state after `epoch` scheduler steps
        "lr_scheduler": {"step_size": lr_drop, "gamma": gamma, "base_lrs": [opt["lr"]],
                         "last_epoch": epoch + 1, "_last_lr": [lr]},
        "epoch": epoch,
        "opt": opt,
        "step": step,
        "lr": lr,
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # a reader never sees half a checkpoint


def save_v1_checkpoint(path: str, params_np: Dict, epoch: int = 0, opt: Optional[Dict] = None,
                       lr: Optional[float] = None) -> None:
    """A `mesm_tpu.v1` file with no optimizer state, as
    mesm_tpu/utils/checkpoint.py:24 writes it: `params_np` is a JAX-package
    parameter tree (convert.jax_params_from_state_dict)."""
    payload = {"format": V1_FORMAT, "model": params_np, "optimizer": None, "epoch": epoch,
               "opt": opt, "lr": lr}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Either format's payload. A v1 payload keeps its `format` key and its
    JAX-package trees (numpy); a torch one is as torch.save wrote it."""
    if is_torch_checkpoint(path):
        return torch.load(path, map_location="cpu", weights_only=False)
    with open(path, "rb") as f:
        payload = _V1Unpickler(f).load()
    if not isinstance(payload, dict) or payload.get("format") != V1_FORMAT:
        raise ValueError(f"{path} is neither a torch checkpoint nor a {V1_FORMAT} one")
    return payload


def count_parameters(model, verbose: bool = True) -> int:
    n = sum(p.numel() for p in model.parameters())
    if verbose:
        print(f"Parameter Count: trainable {n:,d}")
    return n
