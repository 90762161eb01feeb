"""InceptionV3 pool3 feature extractor (the FID network), counterpart of
reed_tpu/encoders/inception.py.

The torchvision inception_v3 trunk with pytorch-fid's changes (InceptionA,
InceptionC and the first InceptionE average-pool without counting the
padding; the second InceptionE max-pools), cut at the global average pool:
2048-d features. BatchNorm runs on its running statistics with eps 1e-3.
The state_dict names are torchvision's and pytorch-fid's
(`Mixed_5b.branch1x1.conv.weight`, `.bn.running_mean`, ...), so reed_tpu's
`convert_torch_inception` loads a port state_dict unchanged; `to_flax` is
the port's copy of it and `load_npz` reads the npz of reed_tpu's
`save_variables_npz` (`params/...` and `batch_stats/...`). Inputs are
NHWC, as reed_tpu's; the convolutions run NCHW in full f32.

Input convention (pytorch-fid): uint8 [N, H, W, 3] -> /255 -> bilinear
resize to 299 -> [-1, 1] (`preprocess_uint8`, on the device).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from reed_tpu_torch import resolve_device
from reed_tpu_torch.encoders import flax_tree


class BasicConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Tuple[int, int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _branches(in_ch: int, spec: Sequence[Tuple]) -> Dict[str, BasicConv2d]:
    """{name: BasicConv2d} from (name, in (None: the block's input), out,
    kernel, stride, padding) rows."""
    return {name: BasicConv2d(in_ch if src is None else src, out, kernel, stride, pad)
            for name, src, out, kernel, stride, pad in spec}


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        for name, conv in _branches(in_ch, [
                ("branch1x1", None, 64, (1, 1), 1, (0, 0)),
                ("branch5x5_1", None, 48, (1, 1), 1, (0, 0)),
                ("branch5x5_2", 48, 64, (5, 5), 1, (2, 2)),
                ("branch3x3dbl_1", None, 64, (1, 1), 1, (0, 0)),
                ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
                ("branch3x3dbl_3", 96, 96, (3, 3), 1, (1, 1)),
                ("branch_pool", None, pool_features, (1, 1), 1, (0, 0))]).items():
            self.add_module(name, conv)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        for name, conv in _branches(in_ch, [
                ("branch3x3", None, 384, (3, 3), 2, (0, 0)),
                ("branch3x3dbl_1", None, 64, (1, 1), 1, (0, 0)),
                ("branch3x3dbl_2", 64, 96, (3, 3), 1, (1, 1)),
                ("branch3x3dbl_3", 96, 96, (3, 3), 2, (0, 0))]).items():
            self.add_module(name, conv)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        for name, conv in _branches(in_ch, [
                ("branch1x1", None, 192, (1, 1), 1, (0, 0)),
                ("branch7x7_1", None, c7, (1, 1), 1, (0, 0)),
                ("branch7x7_2", c7, c7, (1, 7), 1, (0, 3)),
                ("branch7x7_3", c7, 192, (7, 1), 1, (3, 0)),
                ("branch7x7dbl_1", None, c7, (1, 1), 1, (0, 0)),
                ("branch7x7dbl_2", c7, c7, (7, 1), 1, (3, 0)),
                ("branch7x7dbl_3", c7, c7, (1, 7), 1, (0, 3)),
                ("branch7x7dbl_4", c7, c7, (7, 1), 1, (3, 0)),
                ("branch7x7dbl_5", c7, 192, (1, 7), 1, (0, 3)),
                ("branch_pool", None, 192, (1, 1), 1, (0, 0))]).items():
            self.add_module(name, conv)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        for name, conv in _branches(in_ch, [
                ("branch3x3_1", None, 192, (1, 1), 1, (0, 0)),
                ("branch3x3_2", 192, 320, (3, 3), 2, (0, 0)),
                ("branch7x7x3_1", None, 192, (1, 1), 1, (0, 0)),
                ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
                ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
                ("branch7x7x3_4", 192, 192, (3, 3), 2, (0, 0))]).items():
            self.add_module(name, conv)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, in_ch: int, pool_kind: str):
        super().__init__()
        self.pool_kind = pool_kind  # 'avg' (first instance) | 'max' (second, FID)
        for name, conv in _branches(in_ch, [
                ("branch1x1", None, 320, (1, 1), 1, (0, 0)),
                ("branch3x3_1", None, 384, (1, 1), 1, (0, 0)),
                ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
                ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
                ("branch3x3dbl_1", None, 448, (1, 1), 1, (0, 0)),
                ("branch3x3dbl_2", 448, 384, (3, 3), 1, (1, 1)),
                ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
                ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
                ("branch_pool", None, 192, (1, 1), 1, (0, 0))]).items():
            self.add_module(name, conv)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = _avg_pool3(x) if self.pool_kind == "avg" else F.max_pool2d(x, 3, 1, 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3Pool3(nn.Module):
    """Trunk to the 2048-d pool3 features (no fc head)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    @flax_tree.full_f32
    def forward(self, x):
        """x float [N, H, W, 3] in [-1, 1] (299 x 299 for FID) -> [N, 2048]."""
        x = x.permute(0, 3, 1, 2).to(self.Conv2d_1a_3x3.conv.weight.dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def preprocess_uint8(images):
    """uint8 [N, H, W, 3] -> float [-1, 1] at 299 x 299 (bilinear, as
    jax.image.resize: antialiased where it shrinks; torch's antialiased
    kernel is 2e-6 off it where it grows, the plain one 1e-7)."""
    x = images.float() / 255.0
    if x.shape[1] != 299 or x.shape[2] != 299:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                          align_corners=False, antialias=max(x.shape[1:3]) > 299
                          ).permute(0, 2, 3, 1)
    return x * 2.0 - 1.0


# -- weights: torchvision names <-> reed_tpu's flax tree --------------------

_STATS = {"running_mean": "mean", "running_var": "var"}


def flax_key(name: str):
    """(path in reed_tpu's variables, layout) of a torchvision-named entry."""
    *module, layer, leaf = name.split(".")
    if leaf == "num_batches_tracked":
        return None
    if layer == "conv":
        return ("params", *module, "conv", "kernel"), "conv"
    if leaf in _STATS:
        return ("batch_stats", *module, "bn", _STATS[leaf]), "same"
    return ("params", *module, "bn", "scale" if leaf == "weight" else "bias"), "same"


def to_flax(model: nn.Module) -> Dict:
    """The port's copy of reed_tpu's convert_torch_inception:
    {'params': ..., 'batch_stats': ...}."""
    return flax_tree.to_flax(model.state_dict(), flax_key)


def load_npz(path: str, device=None) -> InceptionV3Pool3:
    """InceptionV3Pool3 on `device` (default cuda) with the weights of the
    npz reed_tpu's save_variables_npz writes."""
    model = InceptionV3Pool3()
    model.load_state_dict(flax_tree.from_flax(flax_tree.load_npz(path),
                                              model.state_dict(), flax_key))
    return model.to(resolve_device(device)).eval()


def make_feature_fn(model: InceptionV3Pool3) -> Callable[[np.ndarray], np.ndarray]:
    """feature_fn(uint8 [N, H, W, 3] numpy) -> numpy [N, 2048], for
    eval/frechet.compute_activation_stats; the batch is preprocessed and
    run on the model's device."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def feature_fn(images):
        x = torch.as_tensor(np.ascontiguousarray(images)).to(device)
        return model(preprocess_uint8(x)).cpu().numpy()

    return feature_fn
