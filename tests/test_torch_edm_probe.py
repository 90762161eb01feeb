"""The EDM gate tool's bf16-operand probe (tools/convergence_edm.py
--bf16-matmul-inputs) on the CPU: inside `bf16_matmul_inputs` every f32
F.linear, forward and both backward products, equals the f32 product of
explicitly bf16-rounded operands (to 1e-6 of its max: only the summation
order differs), bf16 inputs pass through untouched, F.linear comes back on
exit; the device check passes; a tiny run writes the probe's record (never
the gate's) with its check and its precision in the config."""

import json
import os

import pytest
import torch
import torch.nn.functional as F

from reed_tpu_torch.tools import convergence_edm as gate

torch.set_num_threads(1)


def _r(t):
    return t.to(torch.bfloat16).float()


def test_linear_rounds_operands_forward_and_backward():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 7, 24), generator=g, requires_grad=True)
    w = torch.randn((16, 24), generator=g, requires_grad=True)
    b = torch.randn((16,), generator=g, requires_grad=True)
    dy = torch.randn((3, 7, 16), generator=g)
    plain = F.linear
    with gate.bf16_matmul_inputs():
        assert F.linear is not plain
        y = F.linear(x, w, b)
        lin = torch.nn.Linear(24, 16)
        assert torch.equal(lin(x.detach()), F.linear(x.detach(), lin.weight, lin.bias))
        xb = x.detach().bfloat16()
        assert torch.equal(F.linear(xb, w.detach().bfloat16()),
                           plain(xb, w.detach().bfloat16()))
    assert F.linear is plain
    gx, gw, gb = torch.autograd.grad(y, (x, w, b), dy)
    want = plain(_r(x.detach()), _r(w.detach())) + b.detach()
    tol = lambda ref: 1e-6 * ref.abs().max()  # noqa: E731
    assert (y.detach() - want).abs().max() <= tol(want)
    assert (y.detach() - plain(x, w, b).detach()).abs().max() > 1e-4 * want.abs().max()
    gx_want = _r(dy) @ _r(w.detach())
    gw_want = _r(dy).reshape(-1, 16).T @ _r(x.detach()).reshape(-1, 24)
    assert (gx - gx_want).abs().max() <= tol(gx_want)
    assert (gw - gw_want).abs().max() <= tol(gw_want)
    assert torch.allclose(gb, dy.sum((0, 1)))


def test_context_restores_on_error_and_check_passes():
    plain = F.linear
    with pytest.raises(RuntimeError):
        with gate.bf16_matmul_inputs():
            raise RuntimeError("inside")
    assert F.linear is plain
    out = gate.check_bf16_matmul(torch.device("cpu"))
    assert out["rounded"] < 1e-5 and out["unrounded"] > 1e-4


def test_probe_writes_its_own_record(tmp_path, monkeypatch):
    plain = F.linear
    monkeypatch.chdir(tmp_path)
    args = ["--device", "cpu", "--steps", "2", "--timesteps", "3", "--batch-size", "4",
            "--hidden", "16", "--layers", "1", "--n-eval", "4", "--workers", "0",
            "--seeds", "0"]
    result = gate.main(args + ["--bf16-matmul-inputs"])
    assert os.listdir(tmp_path) == [gate.PROBE_RECORD]
    with open(tmp_path / gate.PROBE_RECORD) as f:
        record = json.load(f)
    assert record["config"]["matmul_inputs"] == "bfloat16" == result["config"]["matmul_inputs"]
    assert record["bf16_matmul_check"]["grad_rounded"] < 1e-5 and not record["pass"]
    assert F.linear is plain
    with pytest.raises(ValueError, match="gate's record"):
        gate.main(args + ["--bf16-matmul-inputs", "--out", f"x/{gate.GATE_RECORD}"])
    gate.main(args)
    assert sorted(os.listdir(tmp_path)) == sorted([gate.PROBE_RECORD, gate.GATE_RECORD])
