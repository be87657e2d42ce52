"""AMP autocast (counterpart of paddle_tpu/amp/__init__.py:38). bf16 is
the default low precision, as on the reference's device; the lists and
the O1/O2 rules are the reference's (amp/state.py), applied by the
port's functional ops, not by ``torch.autocast``.

GradScaler (loss scaling, a no-op for bf16) is not ported yet."""
from __future__ import annotations

from ..core.dtype import to_dtype
from .state import (BLACK_LIST, WHITE_LIST, amp_dtype, amp_state,
                    is_auto_cast_enabled, maybe_cast_inputs)

__all__ = ["auto_cast", "amp_guard", "WHITE_LIST", "BLACK_LIST",
           "amp_dtype", "amp_state", "is_auto_cast_enabled",
           "maybe_cast_inputs"]


class auto_cast:
    """Context manager enabling the per-op autocast of the port's ops."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16",
                 use_promote=True):
        self.enable = enable
        self.level = level
        self.dtype = to_dtype(dtype)
        self.custom_white = set(custom_white_list or ())
        self.custom_black = set(custom_black_list or ())

    def __enter__(self):
        st = amp_state()
        self._saved = (st.enabled, st.level, st.dtype, st.custom_white,
                       st.custom_black)
        st.enabled = self.enable
        st.level = self.level
        st.dtype = self.dtype
        st.custom_white = self.custom_white
        st.custom_black = self.custom_black
        return self

    def __exit__(self, *exc):
        st = amp_state()
        (st.enabled, st.level, st.dtype, st.custom_white,
         st.custom_black) = self._saved
        return False


amp_guard = auto_cast
