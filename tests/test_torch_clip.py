"""The port's CLIP stack against the JAX package's on the CPU: the tokenizer
(hand-picked strings and a property test over Unicode 15.0), the ViT and
ModifiedResNet towers and the text tower on the same weights (port
state_dict -> the JAX package's clip_params_from_torch_state_dict -> JAX
apply), config_from_state_dict, load_clip_checkpoint on TorchScript, plain
and fp16 files, and the loader's download path with a stub opener."""
import dataclasses
import hashlib
import io

import jax
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from univtg_tpu.extract.clip import tokenizer as jax_tok
from univtg_tpu.extract.clip.model import CLIP as JaxCLIP
from univtg_tpu.extract.clip.model import CLIPConfig as JaxCLIPConfig
from univtg_tpu.interop.clip_ckpt import (
    clip_params_from_torch_state_dict,
    config_from_state_dict as jax_config_from_state_dict,
)
from univtg_tpu_torch.extract.clip import load as clip_load
from univtg_tpu_torch.extract.clip import tokenizer
from univtg_tpu_torch.extract.clip.model import CLIP, CLIPConfig
from univtg_tpu_torch.interop.clip_ckpt import config_from_state_dict, load_clip_checkpoint

torch.set_num_threads(1)
# vision width 64 x 2 layers at 224^2 with patch 32; text width 64 x 2 layers
VIT = dict(embed_dim=32, image_resolution=224, vision_layers=2, vision_width=64,
           vision_patch_size=32, context_length=77, vocab_size=49408,
           transformer_width=64, transformer_heads=4, transformer_layers=2)
# one bottleneck per stage at width 32, resolution 64
RESNET = dict(VIT, embed_dim=64, image_resolution=64, vision_layers=(1, 1, 1, 1),
              vision_width=32, vision_patch_size=0, transformer_width=32)
TOL = dict(atol=1e-4, rtol=1e-4)

TEXTS = [
    "a man is walking his dog in the park",
    "Chef makes pizza and cuts it up.",
    "POV cooking: frying eggs, 100% tasty!",
    "some   extra   spaces &amp; entities &amp;amp; &lt;b&gt; &#39;quoted&#39;",
    "",
    "   ",
    "x² + y³ = ⅔ of Ⅻ",  # No and Nl are numbers, never letters
    "file\x1cseparators\x1dare\x1enot\x1fwhitespace",
    "tab\tnew\nline nbsp　ideographic sep",
    "It'S THE DOG'LL 'RE 'Ve 'M 'D 'T",
    "lonſ s: 'ſ and <|ſtartoftext|>",  # U+017F folds onto s
    "iotaͅsubscript ͅ alone",  # U+0345 matches no alternative
    "<|startoftext|>inline<|endoftext|> !<|endoftext|>",
    "日本語のテキスト、中文。한국어 ١٢٣ ٤",
    "emoji 👍🏽 and flags 🇫🇷 ZWJ 👨‍👩‍👧",
    "a very long query " * 12,
]
SPECIAL = ["&amp;", "&lt;", "&gt;", "&#39;", "&quot;", "&nbsp;", "&amp;amp;", "&#x27;",
           "\x1c", "\x1d", "\x1e", "\x1f", "'s", "'S", "'ll", "'re", "<|endoftext|>",
           "<|startoftext|>", "ſ", "ͅ", "²", " ", "\t", "\n"]


def test_tokenizer_matches_jax_on_hand_picked_strings():
    mine = tokenizer.get_tokenizer()
    ref = jax_tok.get_tokenizer()
    for t in TEXTS:
        assert mine.encode(t) == ref.encode(t), repr(t)


@pytest.mark.parametrize("context_length, max_valid_length", [(77, 32), (77, 77), (40, 8)])
def test_tokenize_framing_matches_jax(context_length, max_valid_length):
    got = tokenizer.tokenize(TEXTS, context_length, max_valid_length)
    want = jax_tok.tokenize(TEXTS, context_length, max_valid_length)
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), context_length)
    np.testing.assert_array_equal(got, want)


_assigned = st.characters(blacklist_categories=("Cs", "Cn"))


@settings(max_examples=300, derandomize=True, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.one_of(st.text(_assigned, max_size=12), st.sampled_from(SPECIAL)),
                max_size=8).map("".join))
def test_tokenizer_matches_jax_over_assigned_code_points(text):
    """Code points Unicode 15.0 assigns, with the characters the two regex
    engines could read differently and html entities mixed in."""
    assert tokenizer.get_tokenizer().encode(text) == jax_tok.get_tokenizer().encode(text)


def _jax_cfg(cfg: CLIPConfig) -> JaxCLIPConfig:
    return JaxCLIPConfig(**dataclasses.asdict(cfg))


def _jax(cfg: CLIPConfig, method=None):
    """The JAX CLIP's apply for ``method`` (default: the logits), jitted:
    one compile is cheaper than the op-by-op dispatch of an eager apply."""
    model = JaxCLIP(_jax_cfg(cfg))
    if method is None:
        return jax.jit(model.apply)
    return jax.jit(lambda params, x: model.apply(params, x, method=method))


def _images(seed, n, res):
    return np.random.default_rng(seed).standard_normal((n, res, res, 3)).astype(np.float32)


def _tokens(seed, cfg, n=3):
    """Random ids with an EOT (the largest id) per row; the last row holds
    the maximum twice, so the pooled row is the first argmax."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((n, cfg.context_length), np.int32)
    for i in range(n):
        L = int(rng.integers(3, 20))
        tokens[i, :L] = rng.integers(1, cfg.vocab_size - 1, L)
        tokens[i, L - 1] = cfg.vocab_size - 1
    tokens[-1, 1] = cfg.vocab_size - 1
    return tokens


def perturbed(sd, seed):
    """``sd`` with seeded noise on the terms OpenAI's initialisation leaves
    trivial and a released checkpoint does not: every bias, the LayerNorm
    and batch-norm affine terms, the running means, and a positive running
    variance in [0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        elif v.is_floating_point() and v.ndim == 1:
            v = v + 0.1 * torch.randn(v.shape, generator=g)
        out[k] = v
    return out


def _port(cfg: CLIPConfig, sd, compute_dtype):
    model = CLIP(dataclasses.replace(cfg, compute_dtype=compute_dtype), device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return model


# bf16 against JAX's bf16, abs, set from readings on these weights: image
# features 0.0156 (ViT, |x| <= 2.0) and 0.133 (ResNet, |x| <= 13.1), text
# last_hidden_state 0.032 and pooler_output 0.023 (|x| <= 3.3), logits
# 0.047; one to two bf16 steps. f32 is held at TOL.
BF16_TOL = {"vit": 0.03, "resnet": 0.25, "text": 0.05, "logits": 0.1}
DTYPES = pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])


@pytest.fixture(scope="module", params=["vit", "resnet"])
def towers(request):
    cfg = CLIPConfig(**(VIT if request.param == "vit" else RESNET))
    sd = perturbed(CLIP(cfg, device="cpu", seed=3).state_dict(), 3)
    params = clip_params_from_torch_state_dict(sd, _jax_cfg(cfg))
    return request.param, cfg, sd, params


@DTYPES
def test_image_tower_matches_jax(towers, compute_dtype):
    kind, cfg, sd, params = towers
    model = _port(cfg, sd, compute_dtype)
    cfg = model.cfg
    imgs = _images(0, 3, cfg.image_resolution)
    with torch.no_grad():
        got = model.encode_image(torch.from_numpy(imgs)).float().numpy()
    want = np.asarray(_jax(cfg, JaxCLIP.encode_image)(params, imgs), np.float32)
    assert got.shape == (3, cfg.embed_dim) and np.isfinite(got).all()
    if compute_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=BF16_TOL[kind])
    elif kind == "vit":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


@DTYPES
def test_text_tower_and_logits_match_jax(towers, compute_dtype):
    _, cfg, sd, params = towers
    model = _port(cfg, sd, compute_dtype)
    cfg = model.cfg
    tokens = _tokens(1, cfg)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(tokens))
        imgs = _images(2, 2, cfg.image_resolution)
        logits = model(torch.from_numpy(imgs), torch.from_numpy(tokens)).float().numpy()
        # JAX's promotion: bf16 activations by the f32 attention weights make
        # the residual stream f32 from the first block on
        x = torch.zeros(1, 4, cfg.transformer_width, dtype=cfg.dtype)
        assert model.transformer(x, cfg.dtype).dtype == torch.float32
    want = _jax(cfg, JaxCLIP.encode_text)(params, tokens)
    want_logits = np.asarray(_jax(cfg)(params, imgs, tokens), np.float32)
    for key in ("last_hidden_state", "pooler_output"):
        g, w = got[key].float().numpy(), np.asarray(want[key], np.float32)
        if compute_dtype == "bfloat16":
            np.testing.assert_allclose(g, w, atol=BF16_TOL["text"])
        else:
            np.testing.assert_allclose(g, w, **TOL)
    if compute_dtype == "bfloat16":
        np.testing.assert_allclose(logits, want_logits, atol=BF16_TOL["logits"])
    else:
        np.testing.assert_allclose(logits, want_logits, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("arch", [VIT, RESNET], ids=["vit", "resnet"])
def test_config_from_state_dict_equals_jax(arch):
    cfg = CLIPConfig(**arch)
    sd = CLIP(cfg, device="cpu").state_dict()
    got = config_from_state_dict(sd)
    assert dataclasses.asdict(got) == dataclasses.asdict(jax_config_from_state_dict(sd))
    assert (got.vision_layers, got.vision_width, got.image_resolution, got.embed_dim) == (
        cfg.vision_layers, cfg.vision_width, cfg.image_resolution, cfg.embed_dim)


def _archive(cfg, seed, path):
    """A TorchScript archive laid out as OpenAI's releases are: CLIP's
    parameters under their names, the three integer entries beside them."""
    clip = CLIP(cfg, device="cpu", seed=seed)
    for name, value in (("input_resolution", cfg.image_resolution),
                        ("context_length", cfg.context_length),
                        ("vocab_size", cfg.vocab_size)):
        clip.register_buffer(name, torch.tensor(value))
    example = (torch.from_numpy(_images(0, 1, cfg.image_resolution)),
               torch.from_numpy(_tokens(0, cfg)).long())
    torch.jit.trace(clip, example).save(str(path))


def _text_cfg():  # transformer_heads = width // 64, as config_from_state_dict infers
    return CLIPConfig(**dict(VIT, transformer_heads=1))


def test_load_clip_checkpoint_reads_archives_and_state_dicts(tmp_path):
    cfg = _text_cfg()
    model = CLIP(cfg, device="cpu", seed=5)
    sd = model.state_dict()
    _archive(cfg, 5, tmp_path / "archive.pt")
    torch.save(sd, tmp_path / "plain.pt")
    torch.save({k: v.half() if v.is_floating_point() else v for k, v in sd.items()},
               tmp_path / "fp16.pt")
    for name in ("archive.pt", "plain.pt", "fp16.pt"):
        got_sd, got_cfg = load_clip_checkpoint(str(tmp_path / name))
        assert got_cfg == cfg, name
        assert set(got_sd) == set(sd), name
        for k, v in sd.items():
            assert got_sd[k].dtype == v.dtype, (name, k)
            exact = name != "fp16.pt" or not v.is_floating_point()
            want = v if exact else v.half().float()
            torch.testing.assert_close(got_sd[k], want, rtol=0, atol=0)
    # a file whose tensors do not make a CLIP fails the strict load
    torch.save({k: v for k, v in sd.items() if k != "ln_final.bias"}, tmp_path / "bad.pt")
    with pytest.raises(RuntimeError, match="ln_final.bias"):
        load_clip_checkpoint(str(tmp_path / "bad.pt"))


def test_load_by_name_with_a_stub_opener(tmp_path, monkeypatch):
    """name -> download (stub opener) -> sha256 check -> cache reuse ->
    state_dict; nothing is downloaded."""
    cfg = _text_cfg()
    sd = CLIP(cfg, device="cpu", seed=6).state_dict()
    blob_path = tmp_path / "fixture.pt"
    torch.save(sd, blob_path)
    blob = blob_path.read_bytes()
    sha = hashlib.sha256(blob).hexdigest()
    calls = []

    class Response(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def opener(url):
        calls.append(url)
        return Response(blob)

    monkeypatch.setitem(clip_load.MODEL_URLS, "Tiny-Test",
                        f"https://example.invalid/{sha}/Tiny-Test.pt")
    root = str(tmp_path / "cache")
    got_sd, got_cfg = clip_load.load("Tiny-Test", root=root, opener=opener)
    assert got_cfg == cfg and len(calls) == 1
    torch.testing.assert_close(got_sd["text_projection"], sd["text_projection"])
    clip_load.load("Tiny-Test", root=root, opener=opener)  # the verified cache
    assert len(calls) == 1
    cached = clip_load.download_weights("Tiny-Test", root, opener=opener)
    with open(cached, "ab") as f:
        f.write(b"junk")
    clip_load.load("Tiny-Test", root=root, opener=opener)  # corrupt -> fetched again
    assert len(calls) == 2

    monkeypatch.setitem(clip_load.MODEL_URLS, "Bad-Test",
                        f"https://example.invalid/{sha}/Bad.pt")
    with pytest.raises(RuntimeError, match="sha256"):
        clip_load.download_weights("Bad-Test", str(tmp_path / "c2"),
                                   opener=lambda url: Response(b"not the weights"))

    def offline(url):
        raise OSError("no network")

    with pytest.raises(RuntimeError, match="offline"):
        clip_load.download_weights("Bad-Test", str(tmp_path / "c3"), opener=offline)
    assert clip_load.load(str(blob_path))[1] == cfg  # a local path, no name table
    with pytest.raises(FileNotFoundError, match="no such checkpoint"):
        clip_load.load(str(tmp_path / "typo" / "ViT-B-16.pt"))
    with pytest.raises(KeyError):
        clip_load.download_weights("No-Such-Model", root)
    assert "ViT-B/32" in clip_load.available_models()
