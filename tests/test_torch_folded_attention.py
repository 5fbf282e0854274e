"""The transformer decoder's folded path (``neusky_torch/nets/transformer.py``):
with more than one key/value token, ``LayerNorm_1`` and the key and value
kernels fold into the query, and the tokens are normalised once and never
projected.  Held here to the explicit blocks (``cross_attention_block``
unfolded over the projected tokens) at RENI's widths and at the parity
tests' tiny ones: outputs, every gradient, and the ``attention.folded_kv``
counter.  The tests marked ``cuda`` need a card and skip without one:

    python -m pytest tests/test_torch_folded_attention.py -m cuda
"""

import pytest
import torch

from neusky_torch.fields.ddf import DDFFieldConfig, DirectionalDistanceField
from neusky_torch.fields.reni import RENIField, RENIFieldConfig
from neusky_torch.nets.transformer import (
    FOLDED_KV, TransformerDecoder, cross_attention_block, dense, layer_norm,
)
from neusky_torch.tree import tree_items, tree_map
from neusky_torch.utils import profiling

# (hidden, heads, blocks, tokens, token width): RENI's decoder, and the
# widths of test_torch_variants.py's decoder parity test
WIDTHS = {"reni": (128, 8, 6, 100, 4), "tiny": (16, 4, 2, 5, 6)}
QUERY_DIM = 10  # RENI's direction features with their NeRF encoding


def _explicit(dec: TransformerDecoder, p, x, cond):
    """The decoder with every block unfolded: the tokens projected to keys
    and values through ``LayerNorm_1`` in each block."""
    q = dense(p["query_embed"], x)[..., None, :]
    kv = dense(p["kv_embed"], cond)
    for i in range(dec.num_layers):
        q = cross_attention_block(p[f"block_{i}"], q, kv)
    return dense(p["out"], layer_norm(p["LayerNorm_0"], q)[..., 0, :])


class _ExplicitDecoder(TransformerDecoder):
    __call__ = _explicit


def _perturbed(tree, seed: int):
    """``tree`` with the LayerNorms' scales and every bias drawn away from
    their init, so that each term of the fold counts."""
    g = torch.Generator().manual_seed(seed)

    def draw(path, t):
        if path.endswith("bias"):
            return 0.1 * torch.randn(t.shape, generator=g, dtype=t.dtype)
        if path.endswith("scale"):
            return 1.0 + 0.2 * torch.randn(t.shape, generator=g, dtype=t.dtype)
        return t

    def walk(tree, path=""):
        return {k: walk(v, f"{path}/{k}") if isinstance(v, dict) else draw(f"{path}/{k}", v)
                for k, v in tree.items()}

    return walk(tree)


def _decoder(widths: str, seed: int = 0):
    hidden, heads, blocks, _, width = WIDTHS[widths]
    dec = TransformerDecoder(hidden, heads, blocks, 3)
    return dec, _perturbed(dec.init(QUERY_DIM, width, torch.Generator().manual_seed(seed), "cpu"), seed + 1)


def _inputs(widths: str, m: int = 48, seed: int = 2):
    _, _, _, tokens, width = WIDTHS[widths]
    g = torch.Generator().manual_seed(seed)
    return torch.randn(m, QUERY_DIM, generator=g), torch.randn(m, tokens, width, generator=g)


def _f64(tree):
    return tree_map(lambda t: t.double(), tree)


def _close(a: torch.Tensor, b: torch.Tensor, floor: float) -> bool:
    """``a`` equals ``b`` to float64 round-off: within 1e-10 of the larger
    of ``b``'s scale and ``floor``."""
    return (a - b).abs().max().item() <= 1e-10 * max(b.abs().max().item(), floor)


@pytest.fixture
def counter():
    profiling.totals[FOLDED_KV] = 0
    yield lambda: profiling.totals[FOLDED_KV]
    del profiling.totals[FOLDED_KV]


# ---------------------------------------------------------------------------
# outputs


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_folded_matches_explicit_in_float64(widths):
    dec, p = _decoder(widths)
    x, cond = _inputs(widths)
    p, x, cond = _f64(p), x.double(), cond.double()
    folded, explicit = dec(p, x, cond), _explicit(dec, p, x, cond)
    assert (folded - explicit).abs().max().item() < 1e-12


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_folded_float32_as_close_to_float64_as_explicit(widths):
    """In float32 the folded path lies within twice the explicit path's
    own error against the float64 answer."""
    dec, p = _decoder(widths)
    x, cond = _inputs(widths, m=256)
    exact = _explicit(dec, _f64(p), x.double(), cond.double())
    err_folded = (dec(p, x, cond).double() - exact).abs().max().item()
    err_explicit = (_explicit(dec, p, x, cond).double() - exact).abs().max().item()
    assert 0.0 < err_explicit and err_folded <= 2.0 * err_explicit, (err_folded, err_explicit)


# ---------------------------------------------------------------------------
# gradients (float64: the two paths are the same function)


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_token_and_query_gradients_match(widths):
    dec, p = _decoder(widths)
    x, cond = _inputs(widths)
    p = _f64(p)
    grads = []
    for fn in (dec.__call__, lambda *a: _explicit(dec, *a)):
        xg, cg = x.double().requires_grad_(True), cond.double().requires_grad_(True)
        torch.sum(torch.sin(fn(p, xg, cg))).backward()
        grads.append((xg.grad, cg.grad))
    (gx, gc), (ex, ec) = grads
    assert _close(gc, ec, 0.0) and _close(gx, ex, 0.0)


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_every_decoder_weight_gradient_matches(widths):
    """Trainable weights, as the RENI trainer trains them: every leaf gets a
    gradient through the folded products.  The key bias's true gradient is
    zero (a shift of one head's logits shared by every token), so leaves
    are held to the larger of their scale and the tree's largest
    gradient's."""
    dec, p = _decoder(widths)
    x, cond = _inputs(widths)
    grads = []
    for fn in (dec.__call__, lambda *a: _explicit(dec, *a)):
        pt = tree_map(lambda t: t.double().requires_grad_(True), p)
        torch.sum(torch.sin(fn(pt, x.double(), cond.double()))).backward()
        grads.append(dict(tree_items(pt)))
    folded, explicit = grads
    floor = max(t.grad.abs().max().item() for t in explicit.values())
    assert set(folded) == set(explicit)
    for k, t in explicit.items():
        assert folded[k].grad is not None, k
        assert _close(folded[k].grad, t.grad, floor), k


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_reni_apply_gradients_with_the_decoder_frozen(widths):
    """``RENIField.apply`` as NeuSky calls it (detached decoder): the
    latents', scales' and rotation's gradients, and the output."""
    hidden, heads, blocks, tokens, _ = WIDTHS[widths]  # RENI's tokens: 4 SO(2) invariants a latent
    cfg = RENIFieldConfig(latent_dim=tokens, hidden_features=hidden, num_attention_heads=heads,
                          num_attention_layers=blocks)
    field = RENIField(cfg)
    params = _f64(_perturbed(field.init(torch.Generator().manual_seed(3), "cpu"), 4))
    g = torch.Generator().manual_seed(5)
    m = 40
    dirs = torch.nn.functional.normalize(torch.randn(m, 3, generator=g, dtype=torch.float64), dim=-1)
    lat = torch.randn(m, tokens, 3, generator=g, dtype=torch.float64)
    scale = torch.rand(m, generator=g, dtype=torch.float64) + 0.5
    rot = torch.linalg.qr(torch.randn(3, 3, generator=g, dtype=torch.float64))[0]
    frozen = tree_map(lambda t: t.detach(), params)
    results = []
    for decoder in (field.decoder, _ExplicitDecoder(hidden, heads, blocks, 3)):
        field.decoder = decoder
        leaves = [t.clone().requires_grad_(True) for t in (lat, scale, rot)]
        out = field.apply(frozen, dirs, *leaves)["rgb"]
        torch.sum(field.unnormalise(out) * 1e-3).backward()
        results.append((out.detach(), [t.grad for t in leaves]))
    (out_f, grads_f), (out_e, grads_e) = results
    assert (out_f - out_e).abs().max().item() < 1e-12
    for name, a, b in zip(("latents", "scale", "rotation"), grads_f, grads_e):
        assert _close(a, b, 0.0), name


# ---------------------------------------------------------------------------
# the counter and the shape rule


@pytest.mark.parametrize("tokens,folded", [(None, 0), (1, 0), (2, 1), (100, 1)],
                         ids=["two_d", "one_token", "two_tokens", "hundred_tokens"])
def test_counter_counts_each_folded_call(counter, tokens, folded):
    """A 2-D conditioning is one token, as is a 3-D one of one token: the
    explicit path, counted 0; more than one token counts 1 a call."""
    dec = TransformerDecoder(16, 4, 2, 3)
    p = dec.init(QUERY_DIM, 4, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(6, QUERY_DIM)
    cond = torch.randn(6, 4) if tokens is None else torch.randn(6, tokens, 4)
    for _ in range(3):
        dec(p, x, cond)
    assert counter() == 3 * folded


def test_ddf_attention_conditioning_stays_explicit(counter):
    """The DDF's ``Attention`` conditioning feeds the encoded positions as
    one token: the explicit path, the counter at 0."""
    ddf = DirectionalDistanceField(DDFFieldConfig(
        position_encoding_type="nerf", direction_encoding_type="nerf", conditioning="Attention",
        hidden_features=32, num_attention_heads=4, num_attention_layers=2, use_bf16_compute=False))
    p = ddf.init(torch.Generator().manual_seed(0), "cpu")
    o = torch.nn.functional.normalize(torch.randn(12, 3), dim=-1)
    out = ddf(p, o, -o)
    assert torch.isfinite(out["expected_termination_dist"]).all() and counter() == 0


def test_neusky_step_counts_two_folded_calls(counter):
    """An eager training step of the tiny recipe decodes the sky twice on
    the folded path: the light directions and the background."""
    from test_torch_profiling import _trainer

    trainer = _trainer()
    trainer.run(2)
    assert counter() == 4


# ---------------------------------------------------------------------------
# on the card

# the queries of a neusky.train sky decode: 16 images × 492 light directions
# and one background direction for each of the 1,024 scene rays
CELL_QUERIES = 16 * 492 + 1024


@pytest.mark.cuda
def test_sky_decode_at_the_cell_size_matches_explicit():
    """RENI's decode of 8,896 directions × 100 latent tokens on the card,
    float32 with TF32 off: the folded path within twice the explicit
    path's own error against the float64 answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    field = RENIField(RENIFieldConfig())
    hidden, heads, blocks = 128, 8, 6
    _, perturbed = _decoder("reni", seed=5)
    params = tree_map(lambda t: t.to(dev), {"params": {"decoder": perturbed}})
    g = torch.Generator().manual_seed(6)
    dirs = torch.nn.functional.normalize(torch.randn(CELL_QUERIES, 3, generator=g), dim=-1).to(dev)
    lat = torch.randn(CELL_QUERIES, 100, 3, generator=g).to(dev)
    scale = (torch.rand(CELL_QUERIES, generator=g) + 0.5).to(dev)
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        field.decoder = _ExplicitDecoder(hidden, heads, blocks, 3)
        exact = field.apply(_f64(params), dirs.double(), lat.double(), scale.double())["rgb"]
        explicit = field.apply(params, dirs, lat, scale)["rgb"]
        field.decoder = TransformerDecoder(hidden, heads, blocks, 3)
        folded = field.apply(params, dirs, lat, scale)["rgb"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    err_folded = (folded.double() - exact).abs().max().item()
    err_explicit = (explicit.double() - exact).abs().max().item()
    assert 0.0 < err_explicit and err_folded <= 2.0 * err_explicit, (err_folded, err_explicit)


@pytest.mark.cuda
def test_captured_step_counts_two_folded_calls_a_replay(counter):
    """A captured NeuSky step re-adds the counter on every replay: 2 each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph")
    from test_torch_profiling import _trainer

    trainer = _trainer(torch.device("cuda"))
    trainer.run(2)  # warm-up, then capture and the first replay
    captured = trainer.train_step.captured
    replays = captured.replays
    profiling.totals[FOLDED_KV] = 0
    trainer.run(3)
    assert captured.replays - replays == 3 and counter() == 6
