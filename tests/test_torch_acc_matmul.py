"""The half-operand product's two routes (``models.nn.acc_matmul``).

The tensor-core route (:class:`~kepler_tpu_torch.models.nn.HalfProduct`)
runs on the card at bf16. Here, on the CPU, it runs under
``models.nn.card_route``, as the device tier records the card's route:
its product step ``torch.mm``/``torch.bmm(..., out_dtype=torch.float32)``
is the plain f32 product of the bf16 operands. At the shapes both refits use
it is held against the plain route (``round_to`` and ``torch.matmul``):

- the forward agrees to f32 summation error;
- every gradient is bf16-valued on both sides and agrees to one bf16 ulp,
  plus what the hi/lo pair of the incoming gradient (2⁻¹⁷ of it) and f32
  sums may move a sum that cancels;
- the pair carries the gradient to 2⁻¹⁷ relative;
- the route runs only at bf16 over a contracted width that is a multiple
  of 8, and the plain route, which the CPU, f16, f32 accuracy mode and
  the 7-wide features keep, is the plain product bit for bit.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from kepler_tpu_torch.models import mlp, nn, temporal, train
from kepler_tpu_torch.models.nn import card_route
from kepler_tpu_torch.ops.attention import round_to
from kepler_tpu_torch.ops.hi_lo import hi_lo, hi_lo_ref

BF16 = torch.bfloat16
CPU = torch.device("cpu")


def takes_route(out: torch.Tensor) -> bool:
    """Whether ``out``'s autograd graph holds a :class:`nn.HalfProduct`."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "HalfProductBackward":
            return True
        todo.extend(fn for fn, _ in node.next_functions)
    return False


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at ``|x|`` (8 significant bits)."""
    _, exp = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), exp - 8)


def bf16_valued(x: torch.Tensor) -> bool:
    return torch.equal(x, x.to(BF16).float())


def linear(m: int, k: int, n: int):
    """``a`` [M, K] @ ``b`` [K, N] by ``acc_matmul``."""
    def run(a, b, cd):
        return nn.acc_matmul(a, b, cd)
    return (m, k), (k, n), run, True


def stacked(e: int, m: int, k: int, n: int):
    """The mixture's expert products: ``a`` [E, M, K] @ ``b`` [E, K, N]
    by ``acc_matmul``."""
    def run(a, b, cd):
        return nn.acc_matmul(a, b, cd)
    return (e, m, k), (e, k, n), run, True


def scores(bsz: int):
    """The single-query scores: q [b, 4, 32] · k [b, 16, 4, 32]."""
    def run(q, k, cd):
        return temporal._query_scores(q, k, cd)
    return (bsz, 4, 32), (bsz, 16, 4, 32), run, False


def values(bsz: int):
    """The single-query output: probs [b, 4, 16] × v [b, 16, 4, 32]."""
    def run(p, v, cd):
        return temporal._weighted_values(p, v, cd)
    return (bsz, 4, 16), (bsz, 16, 4, 32), run, False


CASES = {
    "mlp_in_7x128": linear(300, 7, 128),
    "mlp_hidden_128x128": linear(300, 128, 128),
    "mlp_out_128x4": linear(300, 128, 4),
    "temporal_kv_128x128": linear(40 * 16, 128, 128),
    "temporal_scores": scores(40),
    "temporal_values": values(40),
    "moe_experts_128x4": stacked(8, 300, 128, 4),
}


def operands(shape_a, shape_b, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(shape_a, generator=gen)
    b = torch.randn(shape_b, generator=gen) / shape_b[-2] ** 0.5
    return a.requires_grad_(), b.requires_grad_(), gen


@pytest.mark.parametrize("case", list(CASES))
def test_tensor_core_route_matches_the_plain_product(case):
    shape_a, shape_b, run, linear_case = CASES[case]
    a, b, gen = operands(shape_a, shape_b, 7)
    with card_route(CPU):
        got = run(a, b, BF16)
    assert takes_route(got) == (case != "mlp_in_7x128")
    a0, b0 = a.detach().clone().requires_grad_(), \
        b.detach().clone().requires_grad_()
    want = run(a0, b0, BF16)  # the plain route: the CPU's own
    # the forward: f32 sums of exact products, in another order
    ar, br = round_to(a, BF16).detach(), round_to(b, BF16).detach()
    mag = run(ar.abs(), br.abs(), torch.float32).detach()
    k = shape_a[-1] if linear_case else shape_b[-1] * shape_b[-2]
    assert (got - want).abs().le(k * 2.0 ** -23 * mag + 1e-30).all()
    g = torch.randn(got.shape, generator=gen) * 3.0
    grads = torch.autograd.grad(got, (a, b), g)
    wants = torch.autograd.grad(want, (a0, b0), g)
    # what the pair (2⁻¹⁷ of g) and f32 sums may move a sum: the
    # gradients' products taken over |g|, |a| and |b|
    abs_a = ar.abs().requires_grad_()
    abs_b = br.abs().requires_grad_()
    spread = torch.autograd.grad(run(abs_a, abs_b, torch.float32),
                                 (abs_a, abs_b), g.abs())
    for got_g, want_g, room in zip(grads, wants, spread):
        assert bf16_valued(got_g) and bf16_valued(want_g)
        diff = (got_g - want_g).abs()
        limit = bf16_ulp(torch.maximum(got_g.abs(), want_g.abs())) \
            + (2.0 ** -16 + k * 2.0 ** -23) * room
        assert diff.le(limit).all(), (case, float((diff - limit).max()))
        assert diff.le(bf16_ulp(want_g.abs())).float().mean() > 0.99


def test_a_long_contraction_s_gradient_is_one_product_a_matrix():
    """``_gradient_product``: a right operand's gradient whose contracted
    rows outnumber the batch's matrices (the mixture's experts) is one
    2-D product a matrix, stacked; a batch with more matrices than rows
    (the temporal single-query products: 16 ticks over the sequences) or
    a 2-D product is the one product it was."""
    gen = torch.Generator().manual_seed(9)
    calls = []

    def mul(x, y):
        calls.append(tuple(x.shape))
        return x @ y

    for shape_x, shape_y, want_calls in (
            ((8, 128, 300), (8, 300, 8), [(128, 300)] * 8),
            ((40, 32, 16), (40, 16, 8), [(40, 32, 16)]),
            ((128, 300), (300, 8), [(128, 300)])):
        x = torch.randn(shape_x, generator=gen)
        y = torch.randn(shape_y, generator=gen)
        calls.clear()
        got = nn._gradient_product(mul, x, y)
        assert calls == want_calls
        want = (torch.stack([a @ b for a, b in zip(x, y)])
                if len(want_calls) > 1 else x @ y)
        assert torch.equal(got, want)


@pytest.mark.parametrize("shapes", [((8, 300, 7), (8, 7, 128)),
                                    ((8, 300, 7), (8, 7, 4)),
                                    ((40, 4, 16), (40, 16, 8))])
def test_the_batched_plain_product_is_bmm_with_its_gradients(shapes):
    """:class:`nn.BatchedProduct`, the plain route's batched pair (the
    mixture's 7-wide first layer and skip path): the forward is
    ``torch.bmm`` bit for bit; both gradients are ``torch.bmm``'s own to
    f32 summation order (rtol 1e-5), ``b``'s taken a matrix at a time
    where the rows outnumber the matrices."""
    gen = torch.Generator().manual_seed(13)
    a = torch.randn(shapes[0], generator=gen).requires_grad_()
    b = torch.randn(shapes[1], generator=gen).requires_grad_()
    a0, b0 = (x.detach().clone().requires_grad_() for x in (a, b))
    got = nn.BatchedProduct.apply(a, b)
    want = torch.bmm(a0, b0)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen)
    for x, y in zip(torch.autograd.grad(got, (a, b), g),
                    torch.autograd.grad(want, (a0, b0), g)):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(300, 128), (300, 4), (5, 7), (3, 4, 16)])
def test_hi_lo_pair_carries_the_gradient(shape):
    gen = torch.Generator().manual_seed(3)
    g = torch.randn(shape, generator=gen) * torch.exp(
        4 * torch.randn(shape, generator=gen))
    pair = hi_lo(g, BF16)
    n = shape[-1]
    assert pair.dtype == BF16 and pair.shape == (*shape[:-1], 2 * n)
    hi, lo = pair[..., :n].float(), pair[..., n:].float()
    assert torch.equal(hi, g.to(BF16).float())
    assert (hi + lo - g).abs().le(2.0 ** -17 * g.abs()).all()
    assert torch.equal(pair, hi_lo_ref(g, BF16))


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("cd", [torch.float32, BF16, torch.float16])
@pytest.mark.parametrize("shapes", [((300, 7), (7, 128)),
                                    ((4, 30, 128), (128, 4)),
                                    ((3, 20, 7), (3, 7, 16)),
                                    ((3, 20, 16), (3, 16, 8))])
def test_plain_route_is_the_plain_product(card, cd, shapes):
    """:class:`nn.HalfProduct` runs exactly where the route applies: on
    the card's device types at bf16 over a contracted width that is a
    multiple of 8. Everywhere else (the CPU at every dtype, f16, f32
    accuracy mode, the 7-wide features) the product is the plain one bit
    for bit: ``round_to`` is a no-op at f32."""
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(shapes[0], generator=gen).requires_grad_()
    b = torch.randn(shapes[1], generator=gen)
    with card_route(CPU) if card else contextlib.nullcontext():
        out = nn.acc_matmul(a, b, cd)
    routed = card and cd == BF16 and shapes[0][-1] % 8 == 0
    assert takes_route(out) == routed
    if not routed:
        assert torch.equal(out, torch.matmul(round_to(a, cd),
                                             round_to(b, cd)))


@pytest.mark.parametrize("family", ["mlp", "temporal"])
def test_refit_loss_and_gradients_on_the_route(family):
    """The bf16 refit loss of each family and its gradient through the
    tensor-core route (plain product step) against the plain route: the
    loss to f32 summation error, each leaf's gradient to the bf16
    roundings it passes through."""
    gen = torch.Generator().manual_seed(11)
    if family == "mlp":
        params = mlp.init_mlp(4, generator=gen)
        params["w2"] = torch.randn(128, 4, generator=gen) * 0.1
        feats = torch.rand(64, 10, 7, generator=gen)
        valid = torch.rand(64, 10, generator=gen) < 0.8

        def predict(p):
            return mlp.predict_mlp(p, feats, valid, clamp=False,
                                   compute_dtype=BF16)
    else:
        params = temporal.init_temporal(4, generator=gen)
        params["w_head"] = torch.randn(128, 4, generator=gen) * 0.1
        feats = torch.rand(16, 10, 16, 7, generator=gen)
        valid = torch.rand(16, 10, generator=gen) < 0.8
        t_valid = torch.rand(16, 10, 16, generator=gen) < 0.9

        def predict(p):
            return temporal.predict_temporal(p, feats, valid, t_valid,
                                             clamp=False,
                                             compute_dtype=BF16)
    target = torch.rand(*valid.shape, 4, generator=gen) * 10
    out = {}
    for route in ("plain", "card"):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        with card_route(CPU) if route == "card" else \
                contextlib.nullcontext():
            loss = train.masked_mse(predict(leaves), target, valid)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        out[route] = (loss.item(), dict(zip(leaves, grads)))
    assert out["card"][0] == pytest.approx(out["plain"][0], rel=1e-5)
    for k, want in out["plain"][1].items():
        top = float(want.abs().max())
        torch.testing.assert_close(out["card"][1][k], want, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * top, msg=k)
