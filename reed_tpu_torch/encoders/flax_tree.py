"""Weights between the port's torch state_dicts and reed_tpu's flax
variable trees, for the frozen encoders (SD-VAE, Inception, ViT).

Each model names, for every state_dict entry, its path in the flax tree
(collection first: 'params' or 'batch_stats') and how the array is laid
out there (`key_fn(name) -> (path, kind)`, or None for an entry flax does
not keep). `to_flax` is then the port's own copy of reed_tpu's converter
(convert_diffusers_vae, convert_torch_inception, convert_torch_vit) and
`from_flax` its inverse. The npz files reed_tpu writes for these weights
(tools/convert_vae.py, inception.save_variables_npz,
registry.save_npz_params) are the flat '/'-keyed form of the tree.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

KeyFn = Callable[[str], Optional[Tuple[Tuple[str, ...], str]]]

# torch layout -> flax layout, and back given the torch shape
_TO_FLAX = {
    "same": lambda w: w,
    "dense": lambda w: w.T,                                # [O, I] -> [I, O]
    "conv": lambda w: w.transpose(2, 3, 1, 0),             # [O, I, kh, kw] -> [kh, kw, I, O]
    "linear_conv": lambda w: w.T[None, None],              # Linear [O, I] -> 1x1 conv
    "patch": lambda w: w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]),  # conv -> Dense
}
_FROM_FLAX = {
    "same": lambda a, shape: a,
    "dense": lambda a, shape: a.T,
    "conv": lambda a, shape: a.transpose(3, 2, 0, 1),
    "linear_conv": lambda a, shape: a[0, 0].T,
    "patch": lambda a, shape: a.reshape(shape[2], shape[3], shape[1],
                                        shape[0]).transpose(3, 2, 0, 1),
}


def to_flax(state_dict: Mapping[str, torch.Tensor], key_fn: KeyFn) -> Dict:
    """A state_dict as reed_tpu's variable tree of numpy arrays."""
    tree: Dict = {}
    for name, value in state_dict.items():
        target = key_fn(name)
        if target is None:
            continue
        path, kind = target
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _TO_FLAX[kind](value.detach().cpu().numpy())
    return tree


def from_flax(tree: Mapping, template: Mapping[str, torch.Tensor], key_fn: KeyFn
              ) -> Dict[str, torch.Tensor]:
    """reed_tpu's variable tree as a state_dict with `template`'s names,
    shapes and dtypes (entries flax does not keep are taken from
    `template`)."""
    out = {}
    for name, ref in template.items():
        target = key_fn(name)
        if target is None:
            out[name] = ref.clone()
            continue
        path, kind = target
        node = tree
        for part in path:
            node = node[part]
        arr = np.ascontiguousarray(_FROM_FLAX[kind](np.asarray(node), tuple(ref.shape)))
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{name}: flax {'/'.join(path)} gives {arr.shape}, "
                             f"the model has {tuple(ref.shape)}")
        out[name] = torch.from_numpy(arr).to(ref.dtype)
    return out


def save_npz(path: str, tree: Mapping):
    """A variable tree as a flat npz with 'a/b/c' keys."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    np.savez(path, **flat)


def load_npz(path: str) -> Dict:
    """A flat 'a/b/c'-keyed npz as a nested dict of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree


@contextlib.contextmanager
def _no_tf32():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before


def full_f32(forward):
    """Run a forward with cuDNN's and cuBLAS's TF32 off, whatever the
    process set: torch lets cuDNN run f32 convolutions as 1xTF32 by
    default, and the port never computes f32 in 1xTF32."""
    @functools.wraps(forward)
    def wrapped(*args, **kwargs):
        with _no_tf32():
            return forward(*args, **kwargs)

    return wrapped
