"""Checkpoint download with an md5 check (counterpart of
tracklab_tpu.utils.download)."""
from __future__ import annotations

import hashlib
import logging
from pathlib import Path

log = logging.getLogger(__name__)

__all__ = ["md5sum", "download_file", "get_checkpoint"]


def md5sum(path, chunk=1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as fp:
        while b := fp.read(chunk):
            h.update(b)
    return h.hexdigest()


def download_file(url: str, dest, md5: str | None = None):
    """Fetch ``url`` to ``dest`` unless a file with the right md5 is there;
    a fetched file whose md5 differs is removed and raises ``IOError``."""
    dest = Path(dest)
    if dest.exists() and (md5 is None or md5sum(dest) == md5):
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    import urllib.request
    log.info("Downloading %s -> %s", url, dest)
    urllib.request.urlretrieve(url, dest)  # nosec - user-supplied URL
    if md5 is not None and md5sum(dest) != md5:
        dest.unlink()
        raise IOError(f"md5 mismatch for {url}")
    return dest


def get_checkpoint(path_or_url: str, model_dir="models", md5=None):
    """A local path as it is, or an http(s) URL fetched into ``model_dir``
    under its file name."""
    p = Path(path_or_url)
    if p.exists():
        return p
    if str(path_or_url).startswith(("http://", "https://")):
        return download_file(path_or_url,
                             Path(model_dir) / Path(path_or_url).name, md5)
    raise FileNotFoundError(path_or_url)
