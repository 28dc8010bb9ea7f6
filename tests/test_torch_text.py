"""The port's text side against the JAX package's: the offline RoBERTa text
encoder and its hash tokenizer (gvl_tpu_torch.models.text_encoder), the word
pool and the sentence context block (models.text), and the model's
contrastive head (event projections in the trunk, `encode_text`).

The text encoder holds the JAX bundle's random weights through
`flax_roberta_to_state_dict` and is held to the JAX `apply_fn` within 1e-5
absolute (f32), all-padding rows and empty sentences included. The model
worlds hold noisy JAX parameters (sigma 0.02) through
`jax_params_to_state_dict`; their outputs are held at the forward parity
tests' atol 2e-5 / rtol 2e-4. Tokens must be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvl_tpu.config import Config
from gvl_tpu.models import build_model as jax_build_model
from gvl_tpu.models import text as jtext
from gvl_tpu.models import text_encoder as jte
from gvl_tpu_torch.convert import (flax_roberta_to_state_dict,
                                   jax_params_to_state_dict)
from gvl_tpu_torch.models import text_encoder as pte
from gvl_tpu_torch.models.gvl import GVLArch, build_model
from tests.test_model import tiny_cfg
from tests.test_torch_model import add_noise, make_inputs

TOL = dict(rtol=2e-4, atol=2e-5)
DT = 48            # text width of the model worlds: 12 heads of 4
SENTS = ["A man walks a dog in the park", "", "the", "Then he SITS down .",
         "one two three four five six seven eight nine ten eleven twelve "
         "thirteen fourteen fifteen", "café über naïve"]
# the flagship's text side: attention pool, layer-dependent text features,
# one sentence layer with the cosine position table
FLAGSHIP_TEXT = dict(
    enable_contrastive=True, contrastive_hidden_size=16,
    enable_word_context_modeling=True,
    word_context_modeling_type="attention_pool",
    enable_layer_diff_text_feature=True,
    enable_sentence_context_modeling=True,
    enable_sentence_pos_embedding=True, sentence_pos_embedding_type="cosine",
    sentence_modeling_layer_num=1, max_pos_num=40)
TEXT_CASES = {
    "flagship": {},
    "cross_fusion": dict(enable_cross_model_fusion=True),
    "learned_pos": dict(sentence_pos_embedding_type="learned"),
    "bos_token": dict(enable_word_context_modeling=False,
                      enable_sentence_context_modeling=False,
                      enable_layer_diff_text_feature=False),
    "mean_pool_mlp_e2t": dict(word_context_modeling_type="mean_pool",
                              enable_multilayer_projection=True,
                              disable_cl_proj_layer_share_weight=True,
                              enable_e2t_cl=True),
    "max_pool": dict(word_context_modeling_type="max_pool",
                     enable_sentence_pos_embedding=False),
}


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


# --------------------------------------------------------------- text encoder

def text_encoder_cfg(hidden=64, layers=1, **kw):
    cfg = Config()
    cfg.update(dict(dict(enable_contrastive=True,
                         load_pretrained_language_model_from_config="offline",
                         offline_text_encoder_hidden=hidden,
                         offline_text_encoder_layers=layers), **kw))
    return cfg


def jax_and_port_encoders(hidden, layers):
    """The JAX bundle (its offline RoBERTa) and the port's TextEncoder with
    the bundle's weights."""
    cfg = text_encoder_cfg(hidden, layers)
    bundle = jte.load_text_encoder(cfg)
    assert not bundle.pretrained and bundle.hidden_size == hidden
    enc = pte.load_text_encoder(cfg, device="cpu")
    enc.load_state_dict(flax_roberta_to_state_dict(
        jax.tree_util.tree_map(np.asarray, bundle.params)), strict=True)
    return cfg, bundle, enc


@pytest.mark.parametrize("hidden, layers", [(64, 1), (128, 2)])
def test_text_encoder_matches_flax_roberta(hidden, layers):
    """Last hidden state within 1e-5 absolute, on sentences of every length
    (cut at max_len), an empty sentence (bos, eos only) and a row of
    padding alone (mask all 0: every key masked, uniform attention)."""
    cfg, bundle, enc = jax_and_port_encoders(hidden, layers)
    ids, mask = bundle.tokenize([SENTS, SENTS[::-1]], len(SENTS), 10)
    ids, mask = ids.reshape(-1, 10), mask.reshape(-1, 10)
    ids = np.concatenate([ids, np.ones((1, 10), np.int32)])
    mask = np.concatenate([mask, np.zeros((1, 10), np.int32)])
    want = np.asarray(bundle.apply_fn(bundle.params, jnp.asarray(ids),
                                      jnp.asarray(mask)))
    with torch.no_grad():
        got = enc(t(ids).long(), t(mask))
    assert got.shape == (len(ids), 10, hidden)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hidden, layers", [(64, 1), (128, 2)])
def test_bf16_weight_text_pass_matches_jax_bf16_cast_tree(hidden, layers):
    """The pass under train_use_amp / eval_use_amp: the JAX package applies
    the encoder to `bf16_cast_tree(params)` (Flax's f32 layers promote the
    bf16 weights back, so the arithmetic is f32); the port's bf16_weights
    pass is held to it within 1e-5 absolute, and to an f32 pass over
    weights rounded by hand within 1e-6, while it differs from the f32
    pass by more than 1e-4. Its weight gradients are bfloat16-representable,
    as the cast's transpose rounds them."""
    from gvl_tpu.utils.amp import bf16_cast_tree
    cfg, bundle, enc = jax_and_port_encoders(hidden, layers)
    ids, mask = bundle.tokenize([SENTS, SENTS[::-1]], len(SENTS), 10)
    ids, mask = ids.reshape(-1, 10), mask.reshape(-1, 10)
    want = np.asarray(bundle.apply_fn(bf16_cast_tree(bundle.params),
                                      jnp.asarray(ids), jnp.asarray(mask)))
    assert want.dtype == np.float32
    with torch.no_grad():
        got = enc(t(ids).long(), t(mask), bf16_weights=True)
        f32 = enc(t(ids).long(), t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert float((got - f32).abs().max()) > 1e-4
    rounded = pte.load_text_encoder(cfg, device="cpu")
    rounded.load_state_dict({k: v.to(torch.bfloat16).float()
                             for k, v in enc.state_dict().items()})
    with torch.no_grad():
        by_hand = rounded(t(ids).long(), t(mask))
    assert float((got - by_hand).abs().max()) <= 1e-6
    enc.requires_grad_(True)
    try:
        enc(t(ids).long(), t(mask), bf16_weights=True).square().sum() \
            .backward()
        for n, p in enc.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros(())
            assert torch.equal(g, g.to(torch.bfloat16).float()), n
        assert enc.text_encoder.pooler.dense.weight.grad is None
    finally:
        enc.requires_grad_(False).zero_grad(set_to_none=True)


def test_tokenizers_equal_jax_token_for_token():
    for max_len in (4, 9, 32):
        np.testing.assert_array_equal(
            pte.HashTokenizer(5000)(SENTS, max_len),
            jte.HashTokenizer(5000)(SENTS, max_len))
    raws = [SENTS, SENTS[:2], []]
    tok = jte.HashTokenizer(5000)
    for G in (2, 6, 8):
        want = jte._batch_tokenize(tok, raws, G, 12)
        got = pte._batch_tokenize(pte.HashTokenizer(5000), raws, G, 12)
        for g, w in zip(got, want):
            assert g.shape == (3, G, 12)
            np.testing.assert_array_equal(g, w)
    # an empty sentence is [bos, eos], never an all-padding row
    ids, mask = pte.HashTokenizer(5000)([""], 5)
    assert ids.tolist() == [[0, 2, 1, 1, 1]]
    assert mask.tolist() == [[1, 1, 0, 0, 0]]


def test_text_encoder_numerics_are_roberta_config_defaults():
    """LayerNorm eps 1e-12 (RobertaConfig()'s, not roberta-base's 1e-5),
    exact GELU, position ids from pad + 1 = 2 over non-pad tokens only, a
    finite mask value, no dropout in train mode, and the unused pooler in
    the state_dict under HF names."""
    cfg, bundle, enc = jax_and_port_encoders(64, 1)
    rob = enc.text_encoder
    assert rob.embeddings.LayerNorm.eps == 1e-12
    assert all(m.eps == 1e-12 for m in rob.modules()
               if isinstance(m, torch.nn.LayerNorm))
    inter = rob.encoder.layer[0].intermediate
    h = torch.randn(5, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        pre = inter.dense(h).numpy()
        got = inter(h)
    close(got, jax.nn.gelu(jnp.asarray(pre), approximate=False), atol=1e-6,
          rtol=1e-6)
    assert np.abs(got.numpy() - np.asarray(jax.nn.gelu(
        jnp.asarray(pre), approximate=True))).max() > 1e-5
    # positions: the embedding of a row is that of pad-free positions 2, 3..
    ids = torch.tensor([[0, 7, 2, 1, 1], [1, 1, 1, 1, 1]])
    emb = rob.embeddings
    pos = emb.position_embeddings.weight
    want = emb.LayerNorm(emb.word_embeddings(ids) + emb.token_type_embeddings
                         .weight[0] + pos[torch.tensor([[2, 3, 4, 1, 1],
                                                        [1, 1, 1, 1, 1]])])
    close(emb(ids), want.detach().numpy())
    mask = torch.tensor([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0]])
    enc.train()
    try:
        with torch.no_grad():
            a, b = enc(ids, mask), enc(ids, mask)
    finally:
        enc.eval()
    assert torch.equal(a, b) and torch.isfinite(a).all()
    sd = enc.state_dict()
    assert {"text_encoder.pooler.dense.weight",
            "text_encoder.embeddings.word_embeddings.weight",
            "text_encoder.encoder.layer.0.attention.self.query.weight",
            "text_encoder.encoder.layer.0.output.LayerNorm.bias"} <= set(sd)
    assert not any(p.requires_grad for p in enc.parameters())


def test_text_encoder_spec_and_refusals():
    """The offline spec at the flagship's knobs is roberta-base's widths
    and depth; without load_pretrained_language_model_from_config the
    loader reads the pretrained files and refuses by name files that are
    not there (tests/test_torch_pretrained_text.py reads written ones);
    with the contrastive side off it returns None, as the JAX loader
    does."""
    spec = pte.RobertaSpec.offline(text_encoder_cfg(768, 12))
    assert (spec.hidden_size, spec.num_layers, spec.num_heads,
            spec.intermediate_size, spec.vocab_size, spec.max_positions,
            spec.type_vocab_size, spec.pad_token_id) == \
        (768, 12, 12, 3072, 5000, 514, 1, 1)
    cfg = text_encoder_cfg(
        64, 1, load_pretrained_language_model_from_config=None)
    with pytest.raises(FileNotFoundError,
                       match="pretrained_language_model='roberta-base'"):
        pte.load_text_encoder(cfg, device="cpu")
    cfg.enable_contrastive = False          # no JAX call: it would go online
    assert pte.load_text_encoder(cfg, device="cpu") is None
    assert pte.effective_max_gt_events(tiny_cfg(gt_proposal_sample_num=30)) \
        == tiny_cfg(gt_proposal_sample_num=30).effective_max_gt_events == 30


def test_unmapped_roberta_parameter_raises():
    _, bundle, _ = jax_and_port_encoders(64, 1)
    extra = dict(jax.tree_util.tree_map(np.asarray, bundle.params),
                 lm_head={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="lm_head"):
        flax_roberta_to_state_dict(extra)


# --------------------------------------------------------- the model's side

def text_inputs(cfg, B=2, G=3, Ltok=6, seed=5):
    rs = np.random.RandomState(seed)
    word = rs.randn(B, G, Ltok, DT).astype(np.float32)
    tmask = np.arange(Ltok)[None, None, :] < rs.randint(2, Ltok + 1, (B, G, 1))
    gt_mask = np.arange(G)[None, :] < np.array([G, 2])[:, None]
    return word, tmask, gt_mask


def text_world(**cfg_kw):
    """(cfg, JAX model, noisy JAX params with the text side, port model with
    the same weights, trunk inputs, text inputs)."""
    cfg = tiny_cfg(feature_dim=32, **dict(FLAGSHIP_TEXT, **cfg_kw))
    model = jax_build_model(cfg, text_hidden_dim=DT)
    feats, mask, duration = make_inputs(cfg)
    word, tmask, gt_mask = text_inputs(cfg)
    init = jax.jit(functools.partial(model.init, method=model.init_all))
    params = add_noise(init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(mask),
        jnp.asarray(duration), word_embed=jnp.asarray(word),
        token_mask=jnp.asarray(tmask), gt_mask=jnp.asarray(gt_mask),
        captions=jnp.zeros((2, 3, cfg.max_caption_len), jnp.int32)))
    port = build_model(cfg, text_hidden_dim=DT, device="cpu")
    port.load_state_dict(jax_params_to_state_dict(
        params, GVLArch.from_config(cfg, DT)), strict=True)
    return (cfg, model, params, port, (feats, mask, duration),
            (word, tmask, gt_mask))


_WORLDS = {}


def named_world(name):
    if name not in _WORLDS:
        _WORLDS[name] = (name,) + text_world(**TEXT_CASES[name])
    return _WORLDS[name]


@pytest.fixture(scope="module", params=sorted(TEXT_CASES))
def world(request):
    return named_world(request.param)


def test_trunk_event_embeddings_match_jax(world):
    name, cfg, model, params, port, (feats, mask, duration), _ = world
    want = jax.jit(model.apply)(params, jnp.asarray(feats), jnp.asarray(mask),
                                jnp.asarray(duration))
    with torch.inference_mode():
        got = port(t(feats), t(mask), t(duration))
    assert got["event_embed"].shape == (cfg.dec_layers, 2, cfg.num_queries,
                                        cfg.contrastive_hidden_size)
    close(got["event_embed"], want["event_embed"])
    assert ("background_embed" in got) == cfg.enable_e2t_cl
    if cfg.enable_e2t_cl:
        close(got["background_embed"], want["background_embed"])


def test_encode_text_matches_jax(world):
    """All four outputs, on the JAX trunk's memory, with one padded
    sentence slot and sentences of 2-6 tokens."""
    name, cfg, model, params, port, (feats, mask, duration), txt = world
    out = jax.jit(model.apply)(params, jnp.asarray(feats), jnp.asarray(mask),
                               jnp.asarray(duration))
    word, tmask, gt_mask = txt
    want = jax.jit(functools.partial(model.apply, method=model.encode_text))(
        params, jnp.asarray(word), jnp.asarray(tmask), jnp.asarray(gt_mask),
        out["memory"], out["mask_flat"])
    with torch.inference_mode():
        got = port.encode_text(t(word), t(tmask), t(gt_mask),
                               t(out["memory"]), t(out["mask_flat"]))
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])
    if name == "flagship":      # aux is the pooled, final the context one
        assert float((got["aux"] - got["final"]).abs().max()) > 1e-3


def test_word_attention_pool_matches_jax():
    name, cfg, model, params, port, _, (word, tmask, _) = named_world(
        "flagship")
    jm = jtext.WordAttentionPool(DT)
    tmask = tmask.copy()
    tmask[0, 1] = False                       # a sentence of padding alone
    want = jm.apply({"params": params["params"]["word_context"]},
                    jnp.asarray(word), jnp.asarray(tmask))
    with torch.inference_mode():
        got = port.word_context_model(t(word), t(tmask))
    close(got, want)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("case", ["flagship", "cross_fusion", "learned_pos"])
def test_sentence_context_block_matches_jax(case):
    """The block alone on random sentence features, a padded slot and, for
    cross fusion, a padded video memory; the flagship case has the cosine
    table, learned_pos the learned one, cross_fusion none of them."""
    kw = dict(TEXT_CASES[case])
    if case == "cross_fusion":
        kw["enable_sentence_pos_embedding"] = False
    cfg, model, params, port, _, _ = (named_world(case)[1:] if case
                                      != "cross_fusion" else text_world(**kw))
    rs = np.random.RandomState(9)
    sent = rs.randn(2, 4, DT).astype(np.float32)
    smask = np.array([[1, 1, 1, 1], [1, 1, 0, 0]], bool)
    memory = rs.randn(2, 11, cfg.hidden_dim).astype(np.float32)
    mmask = np.ones((2, 11), bool)
    mmask[1, 7:] = False
    jm = jtext.SentenceContextBlock(
        DT, 1, cfg.enable_sentence_pos_embedding,
        cfg.sentence_pos_embedding_type, cfg.max_pos_num,
        cfg.enable_cross_model_fusion, cfg.hidden_dim,
        n_heads=jtext.bert_head_count(DT))
    want, _ = jm.apply({"params": params["params"]["sentence_context"]},
                       jnp.asarray(sent), jnp.asarray(smask),
                       jnp.asarray(memory), jnp.asarray(mmask))
    with torch.inference_mode():
        got = port.sentence_context_model(t(sent), t(smask), t(memory),
                                          t(mmask))
    close(got, want)
