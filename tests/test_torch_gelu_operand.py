"""The hidden layer's boundary in one pass each way (``ops.gelu_operand``,
``models.nn.gelu_operand``).

On the CPU the kernels' plain versions run, under ``models.nn.card_route``
as the device tier records the card's route:

- the forward is ``F.gelu(z + b, approximate="tanh").to(bf16)`` bit for
  bit, and its backward is autograd's through the unfused passes (the
  operand gradient copied to f32, GELU's backward, the bias gradient's
  sum): ``dz`` bit for bit, the bias gradient to f32 summation order;
- the families record ``kernel:gelu_operand`` (and, with a gradient,
  ``kernel:gelu_operand_backward``) exactly where ``nn.tensor_cores``
  holds, once a boundary;
- everywhere else (the CPU's own route, f16, f32 accuracy mode, a width
  that is no multiple of 8, the packed programs) the outputs are the
  unfused formula's bit for bit.
"""

from __future__ import annotations

import collections
import contextlib

import pytest
import torch
import torch.nn.functional as F

from kepler_tpu_torch.models import deep, mlp, moe, nn, temporal
from kepler_tpu_torch.models.nn import card_route
from kepler_tpu_torch.ops import recorder
from kepler_tpu_torch.parallel import packed
from kepler_tpu_torch.parallel.fleet import MODE_MODEL

BF16 = torch.bfloat16
CPU = torch.device("cpu")
DTYPES = [torch.float32, BF16, torch.float16]


class Kernels:
    """A recorder that counts the hand kernels' calls by name."""

    def __init__(self) -> None:
        self.calls: collections.Counter = collections.Counter()

    @contextlib.contextmanager
    def kernel(self, name: str):
        self.calls[name] += 1
        yield


def unfused(z: torch.Tensor, bias: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """The boundary as the families wrote it before the helper."""
    b = bias[:, None, :] if bias.dim() == 2 else bias
    return F.gelu(z + b, approximate="tanh")


def boundary_inputs(lead: tuple[int, ...], h: int, experts: bool,
                    seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    z = (torch.randn((*lead, h), generator=gen) * 3).requires_grad_()
    bshape = (lead[0], h) if experts else (h,)
    bias = torch.randn(bshape, generator=gen).requires_grad_()
    g = torch.randn((*lead, h), generator=gen).to(BF16)
    return z, bias, g


@pytest.mark.parametrize("lead,experts,h", [((300,), False, 16),
                                            ((300,), False, 24),
                                            ((4, 77), False, 16),
                                            ((8, 4099), True, 16),
                                            ((8, 4099), True, 24),
                                            ((3, 1), True, 16)],
                         ids=["2d", "2d_w24", "3d_rows", "experts",
                              "experts_w24", "one_row"])
def test_plain_version_is_the_unfused_boundary(lead, experts, h):
    """The helper on the route is the unfused forward cast to bf16, and
    its gradients are autograd's through the unfused passes: ``dz`` bit
    for bit, the bias gradient (per expert where the bias is [E, H]) to
    f32 summation order. M is no multiple of the kernel's 256-row tile."""
    z, bias, g = boundary_inputs(lead, h, experts)
    with card_route(CPU):
        out = nn.gelu_operand(z, bias, BF16)
        dz, db = torch.autograd.grad(out, (z, bias), g)
    want = unfused(z, bias, BF16)
    assert out.dtype == BF16 and out.shape == z.shape
    assert torch.equal(out, want.to(BF16))
    wz, wb = torch.autograd.grad(want, (z, bias), g.float())
    assert dz.dtype == db.dtype == torch.float32
    assert torch.equal(dz, wz)
    torch.testing.assert_close(db, wb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("grad", [False, True])
def test_saves_z_and_bias_and_nothing_without_a_gradient(grad):
    """With a gradient the Function saves ``z`` and the bias, as many
    bytes as the unfused GELU's saved input; under ``no_grad`` it runs
    the forward alone and saves nothing."""
    z, bias, _ = boundary_inputs((8, 40), 16, True)
    saved: list[torch.Tensor] = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
            card_route(CPU), \
            contextlib.nullcontext() if grad else torch.no_grad():
        h = nn.gelu_operand(z, bias, BF16)
    assert h.dtype == BF16
    if grad:
        assert [tuple(t.shape) for t in saved] == [(8, 40, 16), (8, 16)]
        assert h.grad_fn is not None
    else:
        assert not saved and h.grad_fn is None


def mlp_case(hidden: int):
    gen = torch.Generator().manual_seed(7)
    params = mlp.init_mlp(4, hidden=hidden, generator=gen)
    params["w2"] = torch.randn(hidden, 4, generator=gen) * 0.1
    feats = torch.rand(6, 10, 7, generator=gen)
    valid = torch.rand(6, 10, generator=gen) < 0.8

    def run(p, cd):
        return mlp.predict_mlp(p, feats, valid, clamp=False,
                               compute_dtype=cd)
    return params, run, 2


def moe_case(hidden: int):
    gen = torch.Generator().manual_seed(8)
    params = moe.init_moe(4, hidden=hidden, generator=gen)
    params["w1"] = torch.randn(8, hidden, 4, generator=gen) * 0.1
    params["b0"] = torch.randn(8, hidden, generator=gen) * 0.1
    feats = torch.rand(6, 10, 7, generator=gen)
    valid = torch.rand(6, 10, generator=gen) < 0.8

    def run(p, cd):
        return moe.predict_moe(p, feats, valid, clamp=False,
                               compute_dtype=cd)
    return params, run, 1


def block_case(hidden: int):
    """The temporal estimator's ``_mlp_block`` at d_model 16."""
    gen = torch.Generator().manual_seed(9)
    d = 16
    params = {"ln2_scale": torch.ones(d), "ln2_bias": torch.zeros(d),
              "w_mlp0": torch.randn(d, hidden, generator=gen) / 4,
              "b_mlp0": torch.randn(hidden, generator=gen) * 0.1,
              "w_mlp1": torch.randn(hidden, d, generator=gen) / 4,
              "b_mlp1": torch.zeros(d)}
    x = torch.randn(5, 3, d, generator=gen)

    def run(p, cd):
        return temporal._mlp_block(p, x, cd)
    return params, run, 1


def deep_case(hidden: int):
    """``predict_deep`` at d_model ``hidden // 4``: 4 blocks."""
    gen = torch.Generator().manual_seed(10)
    params = deep.init_deep(4, d_model=hidden // 4, generator=gen)
    params["w_head"] = torch.randn(hidden // 4, 4, generator=gen) * 0.1
    feats = torch.rand(6, 10, 7, generator=gen)
    valid = torch.rand(6, 10, generator=gen) < 0.8

    def run(p, cd):
        return deep.predict_deep(p, feats, valid, clamp=False,
                                 compute_dtype=cd)
    return params, run, 4


CASES = {"mlp": mlp_case, "moe": moe_case, "temporal_block": block_case,
         "deep": deep_case}


def leaves_of(params):
    if "blocks" in params:
        return [params["blocks"][k] for k in ("b0", "w0", "w1")]
    return list(params.values())


def with_grad(params):
    out = {k: (v.clone().requires_grad_() if torch.is_tensor(v) else
               {kk: vv.clone().requires_grad_() for kk, vv in v.items()})
           for k, v in params.items()}
    return out, leaves_of(out)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cd", DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("hidden", [32, 36])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card_route"])
def test_kernel_recorded_where_the_route_holds(case, cd, hidden, card):
    """Each family records ``kernel:gelu_operand`` once a hidden layer
    exactly where the next product takes the card's route (the card's
    device types at bf16, a width that is a multiple of 8), and with a
    gradient ``kernel:gelu_operand_backward`` as often."""
    params, run, boundaries = CASES[case](hidden)
    leaves_p, leaves = with_grad(params)
    rec = Kernels()
    with card_route(CPU) if card else contextlib.nullcontext(), \
            recorder.recording(rec):
        with torch.no_grad():
            run(params, cd)
        forward_only = dict(rec.calls)
        out = run(leaves_p, cd)
        torch.autograd.grad(out.sum(), leaves)
    routed = card and cd == BF16 and hidden % 8 == 0
    n = boundaries if routed else 0
    assert forward_only.get("gelu_operand", 0) == n
    assert rec.calls["gelu_operand"] == 2 * n
    assert rec.calls["gelu_operand_backward"] == n


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cd,card", [(torch.float32, False),
                                     (BF16, False), (torch.float16, False),
                                     (torch.float32, True),
                                     (torch.float16, True)],
                         ids=["f32", "bf16", "f16", "f32_card_route",
                              "f16_card_route"])
def test_off_the_route_outputs_are_unchanged(case, cd, card, monkeypatch):
    """Off the route (the CPU's plain route at every dtype, f32 accuracy
    mode and f16 under the card's route) each family's output and
    gradients are those of the unfused boundary, bit for bit."""
    params, run, _ = CASES[case](32)
    got = {}
    for label in ("helper", "unfused"):
        if label == "unfused":
            for module in (mlp, moe, temporal, deep):
                monkeypatch.setattr(module, "gelu_operand", unfused)
        p, leaves = with_grad(params)
        with card_route(CPU) if card else contextlib.nullcontext():
            out = run(p, cd)
            grads = torch.autograd.grad(out.square().sum(), leaves)
        got[label] = (out, grads)
    assert torch.equal(got["helper"][0], got["unfused"][0])
    for a, b in zip(got["helper"][1], got["unfused"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["mlp", "moe", "deep"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card_route"])
def test_packed_program_is_unchanged(mode, card, monkeypatch):
    """The packed fleet program runs its estimator at f32, so it takes no
    kernel and its f16 plane is the unfused boundary's bit for bit."""
    from kepler_tpu_torch.models.estimator import initializer

    w, z, n = 8, 2, 16
    gen = torch.Generator().manual_seed(12)
    params = initializer(mode)(z, generator=gen)
    for k, v in params.items():  # zero-initialised heads move nothing
        if torch.is_tensor(v) and not v.any():
            params[k] = torch.randn(v.shape, generator=gen) * 0.1
    lay = packed.PackedLayout(w, z)
    rows = torch.zeros((n, lay.width))
    rows[:, lay.cpu] = torch.rand((n, w), generator=gen) * 5e5
    rows[:, lay.cpu][:, 5:] = float("nan")  # five workloads a node
    rows[:, lay.zone] = torch.rand((n, z), generator=gen) * 2e6
    rows[:, lay.zone_valid] = 1.0
    rows[:, lay.col_ratio] = torch.rand(n, generator=gen)
    rows[:, lay.col_denom] = 1.0 + torch.rand(n, generator=gen) * 2e6
    rows[:, lay.col_dt] = 5.0
    rows[:, lay.col_mode] = float(MODE_MODEL)
    planes = {}
    for label in ("helper", "unfused"):
        if label == "unfused":
            for module in (mlp, moe, deep):
                monkeypatch.setattr(module, "gelu_operand", unfused)
        program = packed.make_packed_fleet_program(w, z, model_mode=mode,
                                                   device="cpu")
        rec = Kernels()
        with card_route(CPU) if card else contextlib.nullcontext(), \
                recorder.recording(rec):
            planes[label] = program(params, rows)
        assert not rec.calls["gelu_operand"]
    assert not planes["helper"].isnan().any()
    assert torch.equal(planes["helper"], planes["unfused"])
