"""The port's pretrained text side read from local HF-format files: the
file finder and safetensors reader (gvl_tpu_torch.utils.hf_files), the
byte-level BPE (gvl_tpu_torch.models.bpe), the pretrained route of
`load_text_encoder` and the pretrained GPT-2 route of `load_gpt2_spec` /
`make_gpt_tokenize`, against HF `AutoTokenizer` and the JAX package.

Nothing is downloaded: each test writes what it reads into tmp_path, with
the test environment's `tokenizers` (byte-level BPE vocabularies trained
on the synthetic world's captions and the fixed sentences below) and
`transformers` (`save_pretrained` of a tiny random RoBERTa MLM and GPT-2),
as a directory and as a hub cache (`models--<name>/refs/main`,
`snapshots/<rev>/`). Token ids and masks must equal HF's exactly; the text
encoder's last hidden state is held to the JAX `load_text_encoder` on the
same hub cache within test_torch_text.py's 1e-5 absolute. Cost: ~40 s in
one process.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvl_tpu.models.text_encoder as jte
import gvl_tpu.train.loop as jloop
from gvl_tpu.config import Config as JConfig
from gvl_tpu.models.gpt_captioner import GPT2Captioner as JaxCaptioner
from gvl_tpu.models.gpt_captioner import GPT2Spec as JaxSpec
from gvl_tpu.train.checkpoint import import_hf_gpt2_state_dict as j_import
from gvl_tpu_torch.config import Config as PConfig
from gvl_tpu_torch.convert import jax_gpt2_head_to_state_dict
from gvl_tpu_torch.data.synthetic import make_synthetic_dataset
from gvl_tpu_torch.models import gpt_captioner as pgpt
from gvl_tpu_torch.models import text_encoder as pte
from gvl_tpu_torch.models.bpe import ByteLevelBPE, pre_tokenize
from gvl_tpu_torch.train import loop as ploop
from gvl_tpu_torch.utils import hf_files

# contractions, digits, punctuation, runs of spaces, empty, accented and
# non-Latin words, other number and letter categories, combining marks,
# special tokens inside the text, and one sentence past every max_len
SENTENCES = [
    "a man is playing the guitar.", "", " ", "  two leading spaces",
    "trailing spaces   ", "They don't, we'll; I'm sure it's 'quoted'",
    "12 fields and 3.5 km, 1,000 dogs!", "Café niño über Straße naïve",
    "中文字符 日本語のテキスト 한국어 Ελληνικά русский", "Ⅷ ½ ² ٣ ൧ numerals",
    "tab\there\nnew\n\nline", "no\xa0break and em space",
    "a combining mark: á", "ǅ title-case Ǆ", "emoji 🎸 guitar",
    "<mask> and <s> in the text", "a  <mask> after spaces </s> x",
    "  'sam THE'S", "?!... --- ***",
    "the woman slides the red ball across the kitchen table fast and then "
    "the dog jumps over the door slowly while a man eats"]
MAX_LENS = (6, 16, 40)


def world_captions(root) -> list:
    anno, *_ = make_synthetic_dataset(str(root), num_videos=12, feat_dim=8)
    return [s for v in json.load(open(anno)).values() for s in v["sentences"]]


def train_bpe(texts, specials):
    from tokenizers import ByteLevelBPETokenizer
    bt = ByteLevelBPETokenizer()
    bt.train_from_iterator(texts, vocab_size=420, min_frequency=1,
                           special_tokens=specials, show_progress=False)
    return bt


def write_roberta(folder, texts, safe=True, hidden=32, layers=2):
    """A tiny random RobertaForMaskedLM (eps 1e-5, as roberta-base; no
    pooler, as an MLM checkpoint) and its tokenizer, by save_pretrained."""
    from transformers import (RobertaConfig, RobertaForMaskedLM,
                              RobertaTokenizerFast)
    os.makedirs(folder, exist_ok=True)
    train_bpe(texts, ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]).save_model(
        folder)
    tok = RobertaTokenizerFast(vocab_file=f"{folder}/vocab.json",
                               merges_file=f"{folder}/merges.txt")
    tok.save_pretrained(folder)
    torch.manual_seed(0)
    cfg = RobertaConfig(vocab_size=len(tok), hidden_size=hidden,
                        num_hidden_layers=layers, num_attention_heads=2,
                        intermediate_size=2 * hidden,
                        max_position_embeddings=48, type_vocab_size=1,
                        layer_norm_eps=1e-5, pad_token_id=1)
    model = RobertaForMaskedLM(cfg).eval()
    model.save_pretrained(folder, safe_serialization=safe)
    return model


def write_gpt2(folder, texts, pad=False):
    """A tiny random GPT2LMHeadModel and its tokenizer (no pad token, as
    GPT-2's own files, unless `pad`)."""
    from transformers import GPT2Config, GPT2LMHeadModel, GPT2TokenizerFast
    os.makedirs(folder, exist_ok=True)
    train_bpe(texts, ["<|endoftext|>"]).save_model(folder)
    tok = GPT2TokenizerFast(vocab_file=f"{folder}/vocab.json",
                            merges_file=f"{folder}/merges.txt")
    if pad:
        tok.pad_token = tok.eos_token
    tok.save_pretrained(folder)
    torch.manual_seed(1)
    model = GPT2LMHeadModel(GPT2Config(vocab_size=len(tok), n_embd=32,
                                       n_layer=2, n_head=2, n_positions=64))
    model.save_pretrained(folder)
    return model


def as_hub_layout(folder, dest):
    """A copy of `folder` laid out as the hub publishes roberta-base and
    gpt2: tokenizer.json but no tokenizer_config.json and no
    special_tokens_map.json, so that the HF class's defaults and
    tokenizer.json's added tokens decide."""
    shutil.copytree(folder, dest)
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        os.remove(os.path.join(dest, name))
    assert os.path.isfile(os.path.join(dest, "tokenizer.json"))
    return dest


def as_hub_cache(folder, cache, name, rev="0123abcd"):
    """Copy `folder`'s files into the hub cache layout under `cache`."""
    root = os.path.join(cache, "models--" + name.replace("/", "--"))
    snap = os.path.join(root, "snapshots", rev)
    shutil.copytree(folder, snap)
    os.makedirs(os.path.join(root, "refs"), exist_ok=True)
    with open(os.path.join(root, "refs", "main"), "w") as f:
        f.write(rev)
    return snap


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    texts = world_captions(root) + SENTENCES
    out = dict(root=root, texts=texts)
    for safe in (True, False):
        out[f"roberta_{safe}"] = (str(root / f"roberta_{safe}"),
                                  write_roberta(str(root / f"roberta_{safe}"),
                                                texts, safe))
    out["gpt2"] = (str(root / "gpt2"), write_gpt2(str(root / "gpt2"), texts))
    out["gpt2_pad"] = (str(root / "gpt2_pad"),
                       write_gpt2(str(root / "gpt2_pad"), texts, pad=True))
    for kind in ("roberta_True", "gpt2"):
        hub = kind.split("_")[0] + "_hub"
        out[hub] = (as_hub_layout(out[kind][0], str(root / hub)),
                    out[kind][1])
    out["cache"] = str(root / "cache")
    as_hub_cache(out["roberta_hub"][0], out["cache"], "roberta-base")
    return out


def auto(folder):
    from transformers import AutoTokenizer
    return AutoTokenizer.from_pretrained(folder)


# ------------------------------------------------------------- the tokenizer

@pytest.mark.parametrize("kind", ["roberta_True", "gpt2", "gpt2_pad",
                                  "roberta_hub", "gpt2_hub"])
def test_bpe_ids_and_decodes_equal_autotokenizer(files, kind):
    """Each sentence's ids, without and with the special tokens around them
    (RoBERTa's <s> ... </s>, through the padded call), and the decode of
    those ids equal HF's fast tokenizer's on the same files; the `_hub`
    kinds are laid out as the hub publishes them (no tokenizer_config.json
    or special_tokens_map.json)."""
    folder = files[kind][0]
    hf, me = auto(folder), ByteLevelBPE.from_dir(folder)
    for s in SENTENCES + files["texts"][:20]:
        bare = hf.encode(s, add_special_tokens=False)
        assert me.encode(s) == bare, s
        want = hf.encode(s, add_special_tokens=True)
        if me.pad_token_id is None:
            assert want == bare, s
        else:
            ids, mask = me([s], 256)
            assert ids[0][mask[0] == 1].tolist() == want, s
        for w in (bare, want):
            assert me.decode(w) == hf.decode(w), s
    assert me.flavour == ("roberta" if kind.startswith("roberta") else "gpt2")


@pytest.mark.parametrize("max_len", MAX_LENS)
def test_bpe_padding_and_truncation_equal_autotokenizer(files, max_len):
    """`padding="max_length", truncation=True`: ids and attention masks
    equal HF's exactly, RoBERTa's and a GPT-2's with a pad token; GPT-2's
    own files name no pad token, and both tokenizers refuse to pad."""
    for kind in ("roberta_True", "roberta_hub", "gpt2_pad"):
        folder = files[kind][0]
        want = auto(folder)(SENTENCES, padding="max_length", truncation=True,
                            max_length=max_len, return_tensors="np")
        ids, mask = ByteLevelBPE.from_dir(folder)(SENTENCES, max_len)
        assert ids.dtype == mask.dtype == np.int32
        np.testing.assert_array_equal(ids, want["input_ids"])
        np.testing.assert_array_equal(mask, want["attention_mask"])
    with pytest.raises(ValueError, match="Asking to pad"):
        auto(files["gpt2"][0])(SENTENCES, padding="max_length",
                               truncation=True, max_length=max_len)
    with pytest.raises(ValueError, match="Asking to pad"):
        ByteLevelBPE.from_dir(files["gpt2"][0])(SENTENCES, max_len)


def test_pre_tokenizer_equals_the_regex_pattern():
    """The hand-written scan gives the `regex` module's split of GPT-2's
    pattern on every sentence (the module is for the test only)."""
    import regex
    pat = regex.compile(r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
                        r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    for s in SENTENCES:
        assert pre_tokenize(s) == pat.findall(s), s


# ------------------------------------------------------------- files, weights

@pytest.mark.parametrize("weights", ["model.safetensors", "pytorch_model.bin"])
def test_weights_file_reads_as_saved(files, weights):
    """Each weights file reads back as the saved state_dict, bit for bit,
    and the port's text encoder takes HF's base-model rules over it: the
    `roberta.` prefix stripped, the LM head and buffers dropped, the
    pooler (absent from an MLM checkpoint) drawn."""
    folder, model = files[f"roberta_{weights == 'model.safetensors'}"]
    assert os.path.isfile(os.path.join(folder, weights))
    sd = hf_files.read_weights(folder)
    want = model.state_dict()
    assert set(sd) <= set(want) and "roberta.embeddings.word_embeddings" \
        ".weight" in sd
    for k, v in sd.items():
        assert torch.equal(v, want[k]), k
    base, dropped = pte.roberta_base_state_dict(sd)
    assert dropped and all(k.startswith("lm_head.") for k in dropped)
    cfg = PConfig().update(dict(enable_contrastive=True,
                                pretrained_language_model=folder))
    enc = pte.load_text_encoder(cfg, device="cpu")
    got = enc.text_encoder.state_dict()
    assert sorted(set(got) - set(base)) == ["pooler.dense.bias",
                                            "pooler.dense.weight"]
    for k, v in base.items():
        assert torch.equal(got[k], v), k
    assert enc.text_encoder.spec.layer_norm_eps == 1e-5


def test_safetensors_writer_and_reader_agree_with_the_library(tmp_path):
    """The port's writer gives a file the `safetensors` library reads, and
    its reader reads the library's files, for every dtype the weights
    use."""
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).to(torch.bfloat16),
               "c": torch.randn(2, 2, generator=g).half(),
               "ids": torch.arange(6).reshape(2, 3),
               "empty": torch.zeros(0, 4)}
    hf_files.write_safetensors(tensors, str(tmp_path / "mine.safetensors"))
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    for got in (load_file(str(tmp_path / "mine.safetensors")),
                hf_files.read_safetensors(str(tmp_path / "lib.safetensors"))):
        assert set(got) == set(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_missing_and_unported_files_are_refused_by_name(files, tmp_path):
    """A name found neither as a directory nor in the hub cache, a
    directory with Flax weights only, and a model_type other than roberta
    are refused by name, the first naming every path searched."""
    cfg = PConfig().update(dict(enable_contrastive=True,
                                pretrained_language_model="roberta-base",
                                huggingface_cache_dir=str(tmp_path / "nil")))
    with pytest.raises(FileNotFoundError) as e:
        pte.load_text_encoder(cfg, device="cpu")
    msg = str(e.value)
    assert "roberta-base" in msg and str(tmp_path / "nil") in msg and \
        os.path.abspath("roberta-base") in msg
    with pytest.raises(FileNotFoundError, match="'gpt2'"):
        pgpt.load_gpt2_spec(PConfig().update(dict(
            caption_decoder_type="gpt2", gpt_model="gpt2",
            huggingface_cache_dir=str(tmp_path / "nil"))))
    flax_only = tmp_path / "flax_only"
    shutil.copytree(files["roberta_True"][0], flax_only)
    os.remove(flax_only / "model.safetensors")
    (flax_only / "flax_model.msgpack").write_bytes(b"")
    cfg.pretrained_language_model = str(flax_only)
    with pytest.raises(FileNotFoundError, match="flax_model.msgpack"):
        pte.load_text_encoder(cfg, device="cpu")
    c = json.loads((flax_only / "config.json").read_text())
    (flax_only / "config.json").write_text(json.dumps(dict(
        c, model_type="bert")))
    with pytest.raises(NotImplementedError, match="model_type 'bert'"):
        pte._check_ported(cfg)


# ----------------------------------------------------- against the JAX side

def test_text_encoder_matches_jax_on_the_same_hub_cache(files):
    """JAX's load_text_encoder and the port's on one hub cache
    (`roberta-base` under huggingface_cache_dir): the JAX bundle is the
    pretrained one; equal ids and masks for every video's sentences (G
    slots, max_len 12), and last_hidden_state within 1e-5."""
    kw = dict(enable_contrastive=True, pretrained_language_model=
              "roberta-base", huggingface_cache_dir=files["cache"])
    bundle = jte.load_text_encoder(JConfig().update(kw))
    assert bundle.pretrained and bundle.hidden_size == 32
    enc = pte.load_text_encoder(PConfig().update(kw), device="cpu")
    raw = [SENTENCES[:7], SENTENCES[7:], files["texts"][:3]]
    want_ids, want_mask = bundle.tokenize(raw, 9, 12)
    ids, mask = enc.tokenize(raw, 9, 12)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(mask, want_mask)
    ids, mask = ids.reshape(-1, 12), mask.reshape(-1, 12)
    want = np.asarray(bundle.apply_fn(bundle.params, jnp.asarray(ids),
                                      jnp.asarray(mask)))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def gpt_cfgs(folder, **kw):
    base = dict(caption_decoder_type="gpt2", gpt_model=folder,
                load_pretrained_language_model_from_config="",
                max_caption_len=10, prefix_length=4, prefix_size=32,
                prefix_num_mapping_layer=3, **kw)
    return JConfig().update(base), PConfig().update(base)


def test_gpt2_spec_tokens_and_decode_match_jax(files):
    """make_gpt_tokenize of both packages on a GPT-2 directory with a pad
    token: the same spec (widths from config.json, stop id encode(".")[0]),
    the same gpt_tokens / gpt_mask per batch, the same decode. On GPT-2's
    own files (no pad token) both build the spec and both raise on the
    first batch."""
    jcfg, pcfg = gpt_cfgs(files["gpt2_pad"][0])
    jspec, jadd, jdec = jloop.make_gpt_tokenize(jcfg)
    pspec, padd, pdec = ploop.make_gpt_tokenize(pcfg)
    assert jspec.vocab_size > 300           # the pretrained spec, not 1000
    for f in ("vocab_size", "n_embd", "n_layer", "n_head", "n_positions",
              "prefix_length", "prefix_size", "prefix_num_mapping_layer",
              "stop_token_id", "mapping_type"):
        assert getattr(pspec, f) == getattr(jspec, f), f
    batch = {"captions_raw": [SENTENCES[:5], SENTENCES[5:7], []]}
    want = jadd(dict(batch))
    got = padd(dict(batch))
    for k in ("gpt_tokens", "gpt_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    for row in want["gpt_tokens"].reshape(-1, 10):
        assert pdec(row) == jdec(row)
    jcfg, pcfg = gpt_cfgs(files["gpt2"][0])
    jspec, jadd, _ = jloop.make_gpt_tokenize(jcfg)
    pspec, padd, _ = ploop.make_gpt_tokenize(pcfg)
    assert pspec.stop_token_id == jspec.stop_token_id
    for add in (jadd, padd):
        with pytest.raises(ValueError, match="Asking to pad"):
            add(dict(batch))


def test_hf_gpt2_import_matches_jax(files):
    """import_hf_gpt2_state_dict of both packages on one HF GPT-2
    state_dict: the same unused keys and unfilled entries (none), and the
    port's head equal to the JAX head's parameters converted."""
    _, pcfg = gpt_cfgs(files["gpt2_pad"][0])
    spec, _ = pgpt.load_gpt2_spec(pcfg)
    model = files["gpt2_pad"][1]
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    head = pgpt.GPT2Captioner(spec, device="cpu")
    unused, unfilled = pgpt.import_hf_gpt2_state_dict(sd, head)
    jhead = JaxCaptioner(jax_spec(spec))
    params = jax.jit(jhead.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, spec.prefix_size)),
        jnp.zeros((1, 3), jnp.int32), jnp.ones((1, 3)))
    jnew, junused, junfilled = j_import(
        {k: v.numpy() for k, v in sd.items()}, params, spec.n_head)
    assert unused == junused == []
    assert unfilled == [] and junfilled == []
    want = jax_gpt2_head_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jnew), spec)
    got = head.state_dict()
    for k, v in got.items():
        if k.startswith("gpt."):
            assert torch.equal(v, want[k]), k


def jax_spec(spec):
    return JaxSpec(**{f: getattr(spec, f) for f in (
        "vocab_size", "n_embd", "n_layer", "n_head", "prefix_length",
        "prefix_size", "mapping_type", "prefix_num_mapping_layer",
        "stop_token_id", "n_positions")})
