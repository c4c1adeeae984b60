"""Path normalization.

Own copy of ``norm_path`` and the parse it runs from
``curvine_tpu/common/path.py:13-106``, which the port's master runs over
every path a request names: paths look like ``cv://host:port/a/b``,
``s3://bucket/key``, or bare ``/a/b``; the scheme and authority are
dropped, ``.`` and ``..`` are resolved and a path that climbs out of the
root is refused (``InvalidPath``)."""

from __future__ import annotations

from curvine_tpu_torch.common.errors import InvalidPath

SEPARATOR = "/"


def _parse(full: str) -> str:
    """The in-namespace part of ``full``, before normalization."""
    if not full:
        raise InvalidPath("empty path")
    path = full
    if "://" in full:
        scheme, rest = full.split("://", 1)
        if not scheme:
            raise InvalidPath(f"bad scheme in {full!r}")
        path = "/" + rest.split("/", 1)[1] if "/" in rest else "/"
    if not path.startswith(SEPARATOR):
        raise InvalidPath(f"path must be absolute: {full!r}")
    return path


def _normalize(p: str) -> str:
    out: list[str] = []
    for c in p.split(SEPARATOR):
        if c in ("", "."):
            continue
        if c == "..":
            if not out:
                raise InvalidPath(f"path escapes root: {p!r}")
            out.pop()
        else:
            out.append(c)
    return SEPARATOR + SEPARATOR.join(out)


def norm_path(p: str) -> str:
    """Normalize a user-supplied path to its in-namespace form (no scheme)."""
    # fast path: already-normal absolute paths (the overwhelmingly common
    # RPC case) skip the parse — batched metadata ops normalize every
    # sub-request path, so this is hot at namespace-bench rates
    if (len(p) > 1 and p[0] == "/" and p[-1] != "/"
            and "//" not in p and "/./" not in p and "/../" not in p
            and not p.endswith(("/.", "/.."))):
        return p
    return _normalize(_parse(p))
