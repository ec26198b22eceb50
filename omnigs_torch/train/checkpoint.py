"""Full-state checkpoints: the model, the Adam state and the iteration.

Counterpart of `omnigs_tpu/train/checkpoint.py`, which writes the same
content as an orbax tree. Here one file holds a flat dict of tensors
(``model/<field>``, ``mu/<param>``, ``nu/<param>``, ``count``,
``iteration``), written with `torch.save` and read with
``torch.load(weights_only=True)``. `checkpoint_from_numpy` turns a JAX
trainer's state, as numpy arrays, into such a file, so that a run begun
in the JAX package continues in the port.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Tuple, Union

import numpy as np
import torch

from omnigs_torch.model.gaussians import FIELD_NAMES, GaussianModel
from omnigs_torch.model.optimizer import AdamState

PathLike = Union[str, Path]


def _write(path: PathLike, model_np: Mapping[str, np.ndarray],
           opt_np: Mapping[str, np.ndarray], iteration: int) -> None:
    blob = {f"model/{k}": torch.from_numpy(np.array(model_np[k])) for k in FIELD_NAMES}
    blob.update({k: torch.from_numpy(np.array(v)) for k, v in opt_np.items()})
    blob["iteration"] = torch.tensor(int(iteration), dtype=torch.int64)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    torch.save(blob, path)


def save_checkpoint(path: PathLike, model: GaussianModel, opt_state: AdamState,
                    iteration: int) -> None:
    _write(path, model.to_numpy(), opt_state.to_numpy(), iteration)


def checkpoint_from_numpy(model_np: Mapping[str, np.ndarray],
                          opt_np: Mapping[str, np.ndarray], iteration: int,
                          path: PathLike) -> None:
    """A JAX trainer's state → a port checkpoint. ``model_np`` holds the
    eleven `GaussianModel` fields (``{k: np.asarray(getattr(model, k))}``),
    ``opt_np`` the Adam state as `AdamState.from_numpy` takes it
    (``mu/<param>``, ``nu/<param>``, ``count``)."""
    _write(path, model_np, {k: np.asarray(v) for k, v in opt_np.items()}, iteration)


def load_checkpoint(path: PathLike, capacity: int, device="cuda"
                    ) -> Tuple[GaussianModel, AdamState, int]:
    """Restore (model, Adam state, iteration) onto ``device``. ``capacity``
    must match the saved arrays' leading dimension."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    saved = blob["model/xyz"].shape[0]
    if saved != capacity:
        raise ValueError(f"{path}: checkpoint capacity {saved} != {capacity}")
    arrays = {k: v.numpy() for k, v in blob.items()}
    model = GaussianModel.from_numpy(
        {k: arrays[f"model/{k}"] for k in FIELD_NAMES}, device=device
    )
    opt_state = AdamState.from_numpy(arrays, device=device)
    return model, opt_state, int(blob["iteration"])
