"""Small filesystem durability helpers (counterpart of
paddle_tpu/utils/fs.py), used by ``framework_io.save``'s crash-safe
write."""
from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """Durably record directory entries (renames/creates) themselves —
    fsyncing the file alone does not persist its directory entry. Best
    effort: silently a no-op on platforms without directory fds."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
