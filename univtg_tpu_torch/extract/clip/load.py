"""Released-weight loader; counterpart of ``univtg_tpu/extract/clip/load.py``.

Downloads a released CLIP checkpoint by name (sha256-addressed public
URLs, upstream run_on_video/clip/clip.py:17-57), verifies the checksum,
caches it under ``~/.cache/univtg_tpu/clip`` (the JAX package's cache: the
same files), and reads the archive into a state_dict + a typed CLIPConfig
(interop/clip_ckpt.py) ready for ``extract.pipeline.ClipEncoder``. There is
no JIT patching step: the state_dict drives the port's own towers.

Offline environments: `load()` on an already-cached or local ``.pt`` never
touches the network; a missing file raises a clear error naming the URL.
"""
from __future__ import annotations

import hashlib
import os
import urllib.request
from typing import Optional

# sha256-in-path URLs published by OpenAI, as vendored by the reference
# (run_on_video/clip/clip.py:17-23; ViT-B/16 from the same public release)
MODEL_URLS = {
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "https://openaipublic.azureedge.net/clip/models/7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
}

DEFAULT_ROOT = os.path.expanduser("~/.cache/univtg_tpu/clip")


def available_models():
    return list(MODEL_URLS)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_weights(
    name: str, root: Optional[str] = None, *, opener=urllib.request.urlopen
) -> str:
    """Fetch (or reuse) the released checkpoint for `name`; returns the
    local path. The expected sha256 is the URL's parent path segment
    (run_on_video/clip/clip.py:31); a cached file with a matching digest
    short-circuits the download, a mismatching one is re-fetched, and a
    mismatching DOWNLOAD raises."""
    if name not in MODEL_URLS:
        raise KeyError(f"unknown CLIP model {name!r}; known: {available_models()}")
    url = MODEL_URLS[name]
    expected = url.split("/")[-2]
    root = root or DEFAULT_ROOT
    os.makedirs(root, exist_ok=True)
    target = os.path.join(root, os.path.basename(url))

    if os.path.isfile(target) and _sha256(target) == expected:
        return target

    tmp = target + ".part"
    try:
        with opener(url) as src, open(tmp, "wb") as out:
            for chunk in iter(lambda: src.read(1 << 16), b""):
                out.write(chunk)
    except OSError as e:
        raise RuntimeError(
            f"cannot download {name} weights from {url} (offline?): {e}. "
            f"Place the file at {target} manually, or pass a local path to "
            f"load()."
        ) from e
    if _sha256(tmp) != expected:
        os.unlink(tmp)
        raise RuntimeError(f"downloaded {name} checkpoint fails sha256 check")
    os.replace(tmp, target)
    return target


def load(name_or_path: str, root: Optional[str] = None, *, opener=urllib.request.urlopen):
    """Name ("ViT-B/32", ...) or local .pt path -> (state_dict, CLIPConfig).

    The reference's clip.load(name) (run_on_video/clip/clip.py:73-162)
    minus the torch-JIT device patching, which the port's towers don't need.
    Feed the result to extract.pipeline.ClipEncoder(state_dict, cfg).
    """
    from univtg_tpu_torch.interop.clip_ckpt import load_clip_checkpoint

    if os.path.isfile(name_or_path):
        path = name_or_path
    elif name_or_path in MODEL_URLS:
        path = download_weights(name_or_path, root, opener=opener)
    elif os.sep in name_or_path or name_or_path.endswith(".pt"):
        # looks like a path, not a catalogue name: a typo'd local file must
        # not fall through to a confusing unknown-model KeyError
        raise FileNotFoundError(
            f"no such checkpoint file: {name_or_path!r} (and it is not one "
            f"of the known model names {available_models()})"
        )
    else:
        path = download_weights(name_or_path, root, opener=opener)  # KeyError
    return load_clip_checkpoint(path)
