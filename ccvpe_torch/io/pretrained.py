"""Pretrained EfficientNet weight resolution: local file, cache, or URL
(the port's copy of ``ccvpe_tpu/io/pretrained.py``; standard library only).

The reference auto-downloads the lukemelas release files the first time a
model is built with ``from_pretrained`` (``efficientnet_pytorch/utils.py:
701-762``: ``url_map``/``url_map_advprop`` + ``model_zoo.load_url``).  This
module reproduces that capability framework-side, so
``--pretrained_b0 auto`` (or ``efficientnet-b3`` etc.) works on a machine
with network access while staying fully offline-testable:

* downloads are atomic (``.part`` + ``os.replace``) into a local cache
  (``$CCVPE_PRETRAINED_CACHE`` or ``~/.cache/ccvpe_torch/pretrained``), so a
  multi-host pod where every process resolves the same spec never reads a
  torn file and only pays one download per host;
* each release filename embeds the first 8 hex chars of the file's sha256
  (torch-hub convention, e.g. ``efficientnet-b0-355c32eb.pth``) — the
  digest is verified after download and on every cache hit;
* ``$CCVPE_PRETRAINED_URL_BASE`` rewrites the URL host+path prefix, which
  is how tests exercise the full path against a local HTTP server and how
  air-gapped sites point at an internal mirror.
"""

from __future__ import annotations

import hashlib
import http.client
import os
import time
import urllib.error
import urllib.request

_RELEASE = ("https://github.com/lukemelas/EfficientNet-PyTorch/releases"
            "/download/1.0/")

# reference efficientnet_pytorch/utils.py:701-711 (standard training)
URL_MAP = {
    "efficientnet-b0": "efficientnet-b0-355c32eb.pth",
    "efficientnet-b1": "efficientnet-b1-f1951068.pth",
    "efficientnet-b2": "efficientnet-b2-8bb594d6.pth",
    "efficientnet-b3": "efficientnet-b3-5fb5a3c3.pth",
    "efficientnet-b4": "efficientnet-b4-6ed6700e.pth",
    "efficientnet-b5": "efficientnet-b5-b6417697.pth",
    "efficientnet-b6": "efficientnet-b6-c76e70fd.pth",
    "efficientnet-b7": "efficientnet-b7-dcc49843.pth",
}

# reference efficientnet_pytorch/utils.py:714-726 (AdvProp training)
URL_MAP_ADVPROP = {
    "efficientnet-b0": "adv-efficientnet-b0-b64d5a18.pth",
    "efficientnet-b1": "adv-efficientnet-b1-0f3ce85a.pth",
    "efficientnet-b2": "adv-efficientnet-b2-6e9d97e5.pth",
    "efficientnet-b3": "adv-efficientnet-b3-cdd7c0f4.pth",
    "efficientnet-b4": "adv-efficientnet-b4-44fb3a87.pth",
    "efficientnet-b5": "adv-efficientnet-b5-86493f6b.pth",
    "efficientnet-b6": "adv-efficientnet-b6-ac80338e.pth",
    "efficientnet-b7": "adv-efficientnet-b7-4652b6dd.pth",
    "efficientnet-b8": "adv-efficientnet-b8-22a8fe65.pth",
}


def cache_dir() -> str:
    d = os.environ.get("CCVPE_PRETRAINED_CACHE")
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache", "ccvpe_torch",
                         "pretrained")
    os.makedirs(d, exist_ok=True)
    return d


def _expected_prefix(filename: str) -> str:
    """The 8-hex sha256 prefix embedded in a release filename, or ''."""
    stem = filename.rsplit(".", 1)[0]
    tag = stem.rsplit("-", 1)[-1]
    if len(tag) == 8 and all(c in "0123456789abcdef" for c in tag):
        return tag
    return ""


def _sha256_prefix(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:8]


def _verify(path: str, filename: str) -> None:
    want = _expected_prefix(filename)
    if not want:
        return
    got = _sha256_prefix(path)
    if got != want:
        raise IOError(
            f"pretrained weight file {path!r} is corrupt: sha256 prefix "
            f"{got} != {want} (from its release filename); delete it and "
            "retry")


def _canonical_name(spec: str) -> str:
    """'auto'/'b0'/'efficientnet-b0' -> 'efficientnet-b0'."""
    s = spec.strip().lower()
    if s == "auto":
        s = "b0"  # CCVPE's backbone (reference models.py:55,99)
    if len(s) == 2 and s[0] == "b" and s[1].isdigit():
        s = "efficientnet-" + s
    return s


def resolve(spec: str, *, advprop: bool = False,
            progress: bool = True) -> str:
    """Turn a ``--pretrained_b0`` value into a local checkpoint path.

    ``spec`` may be a local file path (returned as-is, matching the
    reference's ``weights_path`` branch), or ``auto`` / ``b0``..``b8`` /
    ``efficientnet-bN`` — resolved through the release URL map with a
    verified local cache.  Raises ``FileNotFoundError`` for a path-like
    spec that doesn't exist and ``KeyError`` for an unknown model name.
    """
    if os.path.exists(spec):
        return spec
    name = _canonical_name(spec)
    url_map = URL_MAP_ADVPROP if advprop else URL_MAP
    if name not in url_map:
        if os.sep in spec or spec.endswith(".pth") or spec.endswith(".pt"):
            raise FileNotFoundError(
                f"pretrained weights file not found: {spec!r}")
        raise KeyError(
            f"unknown pretrained spec {spec!r}; expected a local file, "
            f"'auto', or one of {sorted(url_map)}")
    filename = url_map[name]
    dest = os.path.join(cache_dir(), filename)
    if os.path.exists(dest):
        _verify(dest, filename)
        return dest
    base = os.environ.get("CCVPE_PRETRAINED_URL_BASE", _RELEASE)
    if not base.endswith("/"):
        base += "/"
    _download(base + filename, dest, progress=progress)
    _verify(dest, filename)
    return dest


def _download(url: str, dest: str, *, progress: bool = True,
              retries: int = 3) -> None:
    """Atomic, retrying download: write ``dest.part.<pid>``, fsync, rename.

    ``os.replace`` is atomic on POSIX, so concurrent resolvers (multi-host
    launch on a shared filesystem) race benignly — last writer wins with an
    identical file, and no reader ever sees a partial one.
    """
    part = f"{dest}.part.{os.getpid()}"
    last_err: Exception | None = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(
                url, headers={"User-Agent": "ccvpe-torch/1.0"})
            with urllib.request.urlopen(req, timeout=60) as resp, \
                    open(part, "wb") as out:
                total = int(resp.headers.get("Content-Length") or 0)
                done = 0
                while True:
                    chunk = resp.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
                    done += len(chunk)
                    if progress and total:
                        print(f"\rdownloading {os.path.basename(dest)}: "
                              f"{done / max(total, 1):5.1%}", end="",
                              flush=True)
                out.flush()
                os.fsync(out.fileno())
            if progress:
                print()
            os.replace(part, dest)
            return
        except (urllib.error.URLError, OSError, http.client.HTTPException) as e:
            # HTTPException covers mid-body drops (IncompleteRead is NOT an
            # OSError) so a transient blip retries instead of aborting
            last_err = e
            if os.path.exists(part):
                os.unlink(part)
            if attempt + 1 < retries:
                time.sleep(2 ** attempt)
    raise IOError(f"failed to download {url} after {retries} attempts: "
                  f"{last_err}")
