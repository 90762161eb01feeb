"""reed_tpu_torch's data x fsdp mesh over four gloo ranks on the CPU
(tests/torch_dp.py, one spawn for the file), data=2 x fsdp=2, against one
process on the same global batch.

- The mesh layout is reed_tpu's make_mesh reshape to (data, fsdp): rank
  r = d * 2 + f, its fsdp group the ranks 2d and 2d + 1.
- The image and protein cases, and the protein case with accum_steps=2
  and a bf16 mu: every metric, every gradient the update saw, every
  parameter, the EMA and the moments within the 2-rank tolerance
  (tests/test_torch_data_parallel.py) of one process, on every rank; each
  rank holding the plan's share of the state.
"""

import pytest
import torch

import torch_dp
from reed_tpu_torch.models import sit as port_sit

torch.set_num_threads(1)

WORLD = 4
REL = 1e-5  # as tests/test_torch_data_parallel.py
RUNS = {"image": ("image", {}), "protein": ("protein", {}),
        "protein_accum": ("protein", dict(accum_steps=2, mu_dtype="bfloat16"))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp_mesh")
    torch_dp.spawn(out, "fsdp_mesh", world=WORLD)
    return [torch.load(out / f"fsdp_mesh_rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_mesh_layout_is_reed_tpus(ranks):
    for rank, r in enumerate(ranks):
        assert r["groups"][:2] == (rank, WORLD)
        data, fsdp, index, fsdp_ranks, data_ranks = r["groups"][2]
        assert (data, fsdp, index) == (2, 2, rank % 2)
        assert fsdp_ranks == [rank - rank % 2, rank - rank % 2 + 1]
        assert data_ranks == [rank % 2, rank % 2 + 2]


@pytest.mark.parametrize("run", sorted(RUNS))
def test_data2_x_fsdp2_matches_one_process(ranks, run, monkeypatch):
    """Each quantity against the largest of its kind (metrics against the
    step's largest); parameter elements whose gradient is at rounding level
    (below 1e-6 of the step's largest) take Adam's first updates of up to
    lr whatever the gradient's digits, and are held to 2 lr a step, as in
    the data-parallel tests; with accumulation the update sees the mean of
    the micro-steps' gradients, so an element whose micro-step gradients
    cancel (+-3e-4 to a mean of 1.7e-9 in the protein case) is such an
    element too."""
    monkeypatch.setitem(port_sit._SIZES, "SiT-T", torch_dp.TINY_SIT)
    case, optim = RUNS[run]
    with torch_dp.settings(**optim):
        want = torch_dp.run_case(case)
    names = list(want["params"])
    noise = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in want["params"].items()}
    for gw in want["grads"]:
        top = max(float(g.abs().max()) for g in gw)
        for n, g in zip(names, gw):
            noise[n] |= g.abs() < 1e-6 * top
    if optim.get("accum_steps", 1) > 1:
        top = max(float(g.abs().max()) for gw in want["grads"] for g in gw)
        for n, *gs in zip(names, *want["grads"]):
            noise[n] |= (sum(gs) / len(gs)).abs() < 1e-6 * top
    for rank, got in enumerate(r[run] for r in ranks):
        for step, (mg, mw) in enumerate(zip(got["metrics"], want["metrics"])):
            top = max(abs(v) for v in mw.values())
            bad = {k: (mg[k], mw[k]) for k in mw if abs(mg[k] - mw[k]) > REL * top}
            assert not bad, (rank, step, bad)
        for step, (gg, gw) in enumerate(zip(got["grads"], want["grads"])):
            top = max(float(g.abs().max()) for g in gw)
            worst = max(float((a - b).abs().max()) for a, b in zip(gg, gw))
            assert worst <= REL * top, (rank, step, worst / top)
        top_param = max(float(v.abs().max()) for v in want["params"].values())
        for n, w in want["params"].items():
            diff = (got["params"][n] - w).abs()
            bound = torch.where(noise[n], 2 * 2 * want["lr"], REL * top_param)
            assert bool((diff <= bound).all()), (rank, n, float(diff.max()))
        for key in ("mu", "nu"):
            for g, w in zip(got["state"][key], want["state"][key]):
                assert g.dtype == w.dtype
        res = got["resident"]
        assert res["bytes"] == res["expected"] < res["whole"]
    if run == "protein_accum":
        assert ranks[0][run]["state"]["acc"] is not None
        assert ranks[0][run]["state"]["mu"][0].dtype == torch.bfloat16
