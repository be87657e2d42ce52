"""paddle.hub (counterpart of paddle_tpu/hub.py, after
python/paddle/hub.py): hubconf.py-protocol model loading from a local
directory or a GitHub / Gitee repo.

`list`, `help` and `load` import the repo's ``hubconf.py`` and call its
entrypoints. The github and gitee sources download an archive into the
hub cache (``$PADDLE_HUB_DIR``, else ``build/paddle_tpu_torch/hub`` in the
checkout) and then load it locally; without a network the download
raises with a pointer to ``source='local'``."""
from __future__ import annotations

import importlib.util
import os
import sys
import zipfile

__all__ = ["list", "help", "load"]

MODULE_HUBCONF = "hubconf.py"


def _hub_dir() -> str:
    from .utils.build import build_dir
    return os.path.expanduser(os.environ.get("PADDLE_HUB_DIR") or str(
        build_dir() / "hub"))


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, MODULE_HUBCONF)
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no {MODULE_HUBCONF} in {repo_dir!r} — a hub repo must "
            "define its entrypoints there")
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu_torch_hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, repo_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(repo_dir)
    return mod


def _github_dir(repo, source, force_reload=False):
    """Download owner/repo[:branch] into the hub cache; returns the
    extracted directory. force_reload discards the cached checkout."""
    if ":" in repo:
        name, branch = repo.split(":", 1)
    else:
        name, branch = repo, "main"
    owner, proj = name.split("/")
    host = "github.com" if source == "github" else "gitee.com"
    url = f"https://{host}/{owner}/{proj}/archive/{branch}.zip"
    hub_dir = _hub_dir()
    os.makedirs(hub_dir, exist_ok=True)
    out = os.path.join(hub_dir, f"{owner}_{proj}_{branch}")
    if os.path.isdir(out):
        if not force_reload:
            return out
        import shutil
        shutil.rmtree(out)
    zip_path = out + ".zip"
    try:
        import urllib.request
        urllib.request.urlretrieve(url, zip_path)
    except Exception as e:
        raise RuntimeError(
            f"hub: could not download {url} ({e}). In an offline "
            "deployment clone the repo and use "
            "hub.load(local_dir, ..., source='local').") from e
    with zipfile.ZipFile(zip_path) as z:
        names = z.namelist()
        if not names:
            os.remove(zip_path)
            raise RuntimeError(f"hub: {url} produced an empty archive")
        # derive the archive root robustly: the first PATH COMPONENT of
        # the common prefix (the first entry may be a file, and a
        # single-file archive's commonpath is the file path itself)
        try:
            common = os.path.commonpath(names)
        except ValueError:          # mixed absolute/relative entries
            common = ""
        root = common.replace("\\", "/").split("/")[0] if common else ""
        if not root or root in (".", "..") or os.path.isabs(common):
            os.remove(zip_path)
            raise RuntimeError(
                f"hub: archive from {url} has no single root directory; "
                "download it manually and use source='local'")
        src = os.path.join(hub_dir, root)
        if os.path.exists(src):     # stale partial extraction target
            import shutil
            shutil.rmtree(src) if os.path.isdir(src) else os.remove(src)
        z.extractall(hub_dir)
    if not os.path.isdir(src):
        os.remove(zip_path)
        raise RuntimeError(
            f"hub: archive from {url} did not extract to a directory")
    os.rename(src, out)
    os.remove(zip_path)
    return out


def _resolve(repo_dir, source, force_reload=False):
    if source == "local":
        return repo_dir
    if source in ("github", "gitee"):
        return _github_dir(repo_dir, source, force_reload)
    raise ValueError(f"unknown hub source {source!r} "
                     "(expected 'github', 'gitee' or 'local')")


def list(repo_dir, source="github", force_reload=False):  # noqa: A001
    """Entrypoint names exposed by the repo's hubconf.py."""
    mod = _load_hubconf(_resolve(repo_dir, source, force_reload))
    return sorted(n for n, v in vars(mod).items()
                  if callable(v) and not n.startswith("_"))


def help(repo_dir, model, source="github", force_reload=False):  # noqa: A001
    """The entrypoint's docstring."""
    mod = _load_hubconf(_resolve(repo_dir, source, force_reload))
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"hub entrypoint {model!r} not found")
    return fn.__doc__


def load(repo_dir, model, source="github", force_reload=False, **kwargs):
    """Call the entrypoint and return the constructed model."""
    mod = _load_hubconf(_resolve(repo_dir, source, force_reload))
    fn = getattr(mod, model, None)
    if fn is None or not callable(fn):
        raise RuntimeError(f"hub entrypoint {model!r} not found")
    return fn(**kwargs)
