"""Pluggable remote file access (gs:// and friends).

The port's own copy of music_spectrogram_diffusion_tpu/data/remote_io.py
(the port imports nothing of the JAX package).

The dataset configs carry the published gs:// TFRecord paths
(reference datasets.py:54-296, read there by tf.io). This framework is
TF-free, so remote access goes through a small filesystem registry:

  * local paths: plain open/glob.
  * gs:// paths: gcsfs or tensorflow (gfile) when importable, else the
    `gsutil`/`gcloud storage` CLI via a transparent local cache dir,
    else a registered custom fetcher.
  * anything else: register a scheme handler with `register_filesystem`.

A handler is any object with `glob(pattern) -> [paths]` and
`open(path, mode) -> file`; paths returned by glob are fed back to the
same handler's open. `cached_fetch` handlers download to
$MSD_REMOTE_CACHE (default ~/.cache/msd_tpu) and reuse the local copy.
"""

from __future__ import annotations

import glob as globlib
import os
import subprocess
from typing import Callable, Dict, IO, List, Optional

_CACHE_ENV = "MSD_REMOTE_CACHE"


class LocalFilesystem:
  def glob(self, pattern: str) -> List[str]:
    return sorted(globlib.glob(pattern))

  def open(self, path: str, mode: str = "rb") -> IO:
    return open(path, mode)


class GcsFsFilesystem:
  """gs:// via the gcsfs package (when importable).

  Tries ambient credentials first (private mirrors / cache buckets),
  falling back to anonymous access (the published public datasets) the
  first time a credentialed call fails.
  """

  def __init__(self):
    import gcsfs  # raises ImportError when unavailable
    self._gcsfs = gcsfs
    try:
      self._fs = gcsfs.GCSFileSystem()  # default application credentials
      self._anon = False
    except Exception:
      self._fs = gcsfs.GCSFileSystem(token="anon")
      self._anon = True

  @staticmethod
  def _is_auth_error(e: Exception) -> bool:
    """Only credential/permission failures justify the anon fallback;
    transient IO errors and missing files must surface as-is (and must
    not permanently downgrade a client that can read private buckets)."""
    text = f"{type(e).__name__} {e}".lower()
    return any(tok in text for tok in (
        "401", "403", "unauthorized", "forbidden", "permission",
        "accessdenied", "access denied", "invalid_grant", "credential",
        "anonymous caller", "token"))

  def _call(self, op: Callable, *a):
    try:
      return op(self._fs, *a)
    except Exception as e:
      if self._anon or not self._is_auth_error(e):
        raise
      # Credentialed client failed auth (expired/invalid creds on a
      # public bucket): retry this call anonymously, but keep the
      # credentialed client for later calls (it may still be the only
      # way into a private mirror/cache bucket).
      anon_fs = self._gcsfs.GCSFileSystem(token="anon")
      return op(anon_fs, *a)

  def glob(self, pattern: str) -> List[str]:
    return [f"gs://{p}" for p in sorted(
        self._call(lambda fs, p: fs.glob(p), pattern))]

  def open(self, path: str, mode: str = "rb") -> IO:
    return self._call(lambda fs, p, m: fs.open(p, m), path, mode)


class GsutilCacheFilesystem:
  """gs:// via the gsutil / `gcloud storage` CLI with a local cache."""

  def __init__(self, cache_dir: Optional[str] = None):
    self.cache_dir = (cache_dir or os.environ.get(_CACHE_ENV)
                      or os.path.expanduser("~/.cache/msd_tpu"))
    self._cli = self._find_cli()
    if self._cli is None:
      raise RuntimeError("neither gsutil nor gcloud found on PATH")

  @staticmethod
  def _find_cli():
    import shutil
    if shutil.which("gsutil"):
      return ["gsutil"]
    if shutil.which("gcloud"):
      return ["gcloud", "storage"]
    return None

  def glob(self, pattern: str) -> List[str]:
    out = subprocess.run(self._cli + ["ls", pattern],
                         capture_output=True, text=True, check=True)
    return sorted(line for line in out.stdout.splitlines() if line)

  def _local_path(self, path: str) -> str:
    assert path.startswith("gs://")
    local = os.path.join(self.cache_dir, path[len("gs://"):])
    if not os.path.exists(local):
      os.makedirs(os.path.dirname(local), exist_ok=True)
      # Download to a temp name and rename on success: an interrupted
      # copy must not leave a truncated file at the final path (it
      # would satisfy the exists() check forever after).
      tmp = local + ".tmp"
      try:
        subprocess.run(self._cli + ["cp", path, tmp], check=True)
        os.replace(tmp, local)
      finally:
        if os.path.exists(tmp):
          os.remove(tmp)
    return local

  def open(self, path: str, mode: str = "rb") -> IO:
    return open(self._local_path(path), mode)


# scheme -> factory (instantiated lazily, cached).
_FACTORIES: Dict[str, Callable[[], object]] = {}
_INSTANCES: Dict[str, object] = {}


def register_filesystem(scheme: str, factory: Callable[[], object]) -> None:
  """Register (or override) the handler factory for a URL scheme."""
  _FACTORIES[scheme] = factory
  _INSTANCES.pop(scheme, None)


def _default_gcs():
  errors = []
  for cls in (GcsFsFilesystem, GsutilCacheFilesystem):
    try:
      return cls()
    except Exception as e:  # noqa: BLE001 - fall through to next backend
      errors.append(f"{cls.__name__}: {e}")
  raise FileNotFoundError(
      "no gs:// backend available (tried gcsfs, gsutil/gcloud). Either "
      "mirror the files locally and pass data_root=, install gcsfs, or "
      "register_filesystem('gs', ...) with a custom fetcher. Details: "
      + "; ".join(errors))


register_filesystem("gs", _default_gcs)
register_filesystem("", LocalFilesystem)


def _scheme(path: str) -> str:
  if "://" in path:
    return path.split("://", 1)[0]
  return ""


def filesystem_for(path: str):
  scheme = _scheme(path)
  if scheme not in _FACTORIES:
    raise ValueError(f"no filesystem registered for scheme {scheme!r} "
                     f"({path})")
  if scheme not in _INSTANCES:
    _INSTANCES[scheme] = _FACTORIES[scheme]()
  return _INSTANCES[scheme]


def glob(pattern: str) -> List[str]:
  return filesystem_for(pattern).glob(pattern)


def open_file(path: str, mode: str = "rb") -> IO:
  return filesystem_for(path).open(path, mode)
