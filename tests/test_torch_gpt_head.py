"""The port's GPT-2 (ClipCap) caption head against the JAX package's, alone,
at the widths of tests/test_gpt2_import.py (E 48, 2 layers, 4 heads, vocab
211, prefix length 5, prefix_size 16), with both prefix mappers, in f32.

Both heads hold the same weights: the JAX init with seeded noise (sigma
0.02, so zero biases and unit LayerNorm scales are not what a transposed or
misplaced tensor would also give) goes through
gvl_tpu_torch.convert.jax_gpt2_head_to_state_dict. Tolerance 1e-5 (atol
and rtol) on the mapper, the GPT-2 forward, prime and step, the loss, the
logits and every gradient (each gradient to 1e-5 of its max abs, plus
1e-7 for the key biases' gradients, which are rounding noise); decoded
tokens exact and their probabilities to 1e-5, for the three `sample`
variants (the cached loop, its early exit and the re-forward oracle). The
HF round trip: the port's head state_dict, less its `gpt.` prefix, goes
through gvl_tpu/train/checkpoint.py import_hf_gpt2_state_dict with no key
left unused or unfilled, and the JAX head on the imported tree gives the
port's logits. Every JAX call is jitted. Cost: ~40 s in one process.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.models.gpt_captioner import GPT2Captioner as JaxCaptioner
from gvl_tpu.models.gpt_captioner import GPT2Spec as JaxSpec
from gvl_tpu.train.checkpoint import import_hf_gpt2_state_dict
from gvl_tpu_torch.convert import jax_gpt2_head_to_state_dict
from gvl_tpu_torch.models.gpt_captioner import GPT2Captioner, GPT2Spec

E, NL, NH, V, PFX_LEN, PFX_SIZE = 48, 2, 4, 211, 5, 16
N, LG, ENTRY = 3, 7, 6
TOL = dict(rtol=1e-5, atol=1e-5)
# the key biases' gradients are 0 in exact arithmetic (a constant added to a
# softmax row's logits) and rounding noise of ~1e-8 in either framework
GRAD_FLOOR = 1e-7
MAPPERS = ("mlp", "transformer")


def specs(mapping: str, stop: int = 13):
    kw = dict(vocab_size=V, n_embd=E, n_layer=NL, n_head=NH,
              prefix_length=PFX_LEN, prefix_size=PFX_SIZE,
              mapping_type=mapping, prefix_num_mapping_layer=2,
              stop_token_id=stop, n_positions=64)
    return JaxSpec(**kw), GPT2Spec(**kw)


def inputs():
    rs = np.random.RandomState(0)
    prefix = rs.randn(N, PFX_SIZE).astype(np.float32)
    tokens = rs.randint(1, V, (N, LG)).astype(np.int32)
    mask = np.ones((N, LG), np.float32)
    mask[1, 4:] = 0
    mask[2, 2:] = 0
    return prefix, tokens, mask


def jitted(head, method, **static):
    fn = functools.partial(head.apply, method=method, **static)
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def world(mapping: str):
    """(JAX spec, JAX head, noisy JAX params, port head with the same
    weights)."""
    jspec, pspec = specs(mapping)
    head = JaxCaptioner(jspec)
    prefix, tokens, mask = inputs()
    params = jax.jit(head.init)(jax.random.PRNGKey(0), prefix, tokens, mask)
    rs = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rs.randn(*np.shape(x)).astype(
            np.float32), params)
    port = GPT2Captioner(pspec)
    port.load_state_dict(jax_gpt2_head_to_state_dict(params, pspec))
    return jspec, head, params, port.eval()


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("mapping", MAPPERS)
def test_prefix_mapper_matches_jax(mapping):
    _, head, params, port = world(mapping)
    prefix, *_ = inputs()
    want = jitted(head, lambda m, x: m.clip_project(x))(params, prefix)
    with torch.no_grad():
        got = port.clip_project(t(prefix))
    assert got.shape == (N, PFX_LEN, E)
    close(got, want)


def embeds(port, tokens):
    """A (N, P + LG, E) input: the mapped prefix and the token embeddings."""
    prefix, *_ = inputs()
    with torch.no_grad():
        return torch.cat([port.clip_project(t(prefix)),
                          port.gpt.embed(t(tokens))], dim=1)


@pytest.mark.parametrize("mapping", MAPPERS)
def test_gpt2_forward_matches_jax(mapping):
    _, head, params, port = world(mapping)
    _, tokens, mask = inputs()
    x = embeds(port, tokens)
    full = np.concatenate([np.ones((N, PFX_LEN), np.float32), mask], 1)
    want = jitted(head, lambda m, x, a: m.gpt(x, a))(params, x.numpy(), full)
    with torch.no_grad():
        got = port.gpt(x, t(full))
    assert got.shape == (N, PFX_LEN + LG, V)
    close(got, want)


@pytest.mark.parametrize("mapping", MAPPERS)
def test_prime_and_step_match_jax_and_the_full_forward(mapping):
    """prime over the prefix, then three cached steps: each step's logits
    equal JAX's prime/step and the port's own full forward at that
    position."""
    _, head, params, port = world(mapping)
    _, tokens, _ = inputs()
    x = embeds(port, tokens)
    L = PFX_LEN + 3
    lmax = PFX_LEN + ENTRY

    def jax_chain(m, x):
        lp, caches = m.gpt.prime(x[:, :PFX_LEN], lmax)
        outs = [lp[:, -1]]
        for j in range(3):
            lg, caches = m.gpt.step(x[:, PFX_LEN + j:PFX_LEN + j + 1],
                                    PFX_LEN + j, caches)
            outs.append(lg)
        return jnp.stack(outs, 1)

    want = jax.jit(functools.partial(head.apply, method=jax_chain))(
        params, x.numpy())
    with torch.no_grad():
        lp, caches = port.gpt.prime(x[:, :PFX_LEN])
        got = [lp]
        for j in range(3):
            got.append(port.gpt.step(x[:, PFX_LEN + j:PFX_LEN + j + 1],
                                     PFX_LEN + j, caches))
        got = torch.stack(got, 1)
        full = port.gpt(x[:, :L], torch.ones(N, L))[:, PFX_LEN - 1:L]
    close(got, want)
    close(got, full.numpy())
    assert all(len(c) == 4 for c in caches)


@pytest.mark.parametrize("mapping", MAPPERS)
def test_loss_and_logits_match_jax(mapping):
    _, head, params, port = world(mapping)
    prefix, tokens, mask = inputs()
    want_loss, want_logits = jax.jit(head.apply)(params, prefix, tokens, mask)
    with torch.no_grad():
        loss, logits = port(t(prefix), t(tokens), t(mask))
    assert logits.shape == (N, LG, V)
    close(logits, want_logits)
    close(loss, want_loss)


@pytest.mark.parametrize("mapping", MAPPERS)
def test_every_gradient_matches_jax(mapping):
    jspec, head, params, port = world(mapping)
    prefix, tokens, mask = inputs()

    def loss_fn(p):
        return head.apply(p, prefix, tokens, mask)[0].sum()

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(params))
    want = jax_gpt2_head_to_state_dict(grads, specs(mapping)[1])
    port.zero_grad(set_to_none=True)
    port(t(prefix), t(tokens), t(mask))[0].sum().backward()
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for n, w in want.items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(got[n].grad.numpy(), w, rtol=0,
                                   atol=1e-5 * scale + GRAD_FLOOR, err_msg=n)


@functools.lru_cache(maxsize=None)
def stop_token(mapping: str) -> int:
    """A token the random head argmaxes often: as the stop token it cuts
    captions at different steps, so the early exit and the masks are
    exercised."""
    jspec, head, params, _ = world(mapping)
    prefix, *_ = inputs()
    j = JaxCaptioner(dataclasses.replace(jspec, stop_token_id=-1))
    toks, _, _ = jitted(j, j.sample, entry_length=ENTRY)(params, prefix)
    return int(np.bincount(np.asarray(toks)[:, 1:].ravel()).argmax())


@pytest.mark.parametrize("mapping", MAPPERS)
@pytest.mark.parametrize("variant", ["cached", "early_exit", "no_cache"])
def test_sample_matches_jax(mapping, variant):
    jspec, _, params, port = world(mapping)
    prefix, *_ = inputs()
    stop = stop_token(mapping)
    j = JaxCaptioner(dataclasses.replace(jspec, stop_token_id=stop))
    kw = dict(entry_length=ENTRY, use_cache=variant != "no_cache",
              early_exit=variant == "early_exit")
    want = jax.device_get(jitted(j, j.sample, **kw)(params, prefix))
    port.spec = dataclasses.replace(port.spec, stop_token_id=stop)
    try:
        with torch.no_grad():
            got = port.sample(t(prefix), **kw)
    finally:
        port.spec = dataclasses.replace(port.spec, stop_token_id=13)
    toks, probs, masks = (x.numpy() for x in got)
    np.testing.assert_array_equal(toks, want[0])
    np.testing.assert_allclose(probs, want[1], **TOL)
    np.testing.assert_array_equal(masks, want[2])
    # the stop cuts some captions short and not others
    lengths = masks.sum(1)
    assert lengths.min() < ENTRY or variant == "no_cache", lengths
    assert probs.dtype == np.float32


@pytest.mark.parametrize("mapping", MAPPERS)
def test_hf_gpt2_round_trip(mapping):
    """The port's head state_dict, less its `gpt.` prefix, is an HF GPT-2
    (and, with the MLP mapper, reference ClipCap) state_dict: the JAX
    importer uses every key and fills every parameter, and the JAX head on
    the imported tree gives the port's logits. The transformer mapper has no
    reference layout, so its keys stay out and its parameters stay."""
    jspec, head, params, port = world(mapping)
    prefix, tokens, mask = inputs()
    sd = {(k[4:] if k.startswith("gpt.") else k): v.numpy()
          for k, v in port.state_dict().items()}
    if mapping != "mlp":
        sd = {k: v for k, v in sd.items() if not k.startswith("clip_project")}
    assert any(k.startswith("transformer.h.1.attn.c_attn") for k in sd)
    zeroed = jax.tree_util.tree_map(np.zeros_like, params)
    if mapping != "mlp":
        zeroed["params"]["clip_project"] = params["params"]["clip_project"]
    new, unused, unfilled = import_hf_gpt2_state_dict(sd, zeroed, NH)
    assert unused == [] and unfilled == []
    _, want = jax.jit(head.apply)(new, prefix, tokens, mask)
    with torch.no_grad():
        _, got = port(t(prefix), t(tokens), t(mask))
    close(got, want)
