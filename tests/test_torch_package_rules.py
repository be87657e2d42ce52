"""paddle_tpu_torch's package rules: it never imports jax or anything of
paddle_tpu (chip_smoke.py neither), and its entry points run on the CUDA
card unless the caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import LLMEngine
from paddle_tpu_torch.models import GPTForCausalLM, generate, gpt_tiny

ROOT = Path(__file__).resolve().parents[1]

_SERVE = """
import sys
import numpy as np
import paddle_tpu_torch
from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.inference import LLMEngine
m = GPTForCausalLM(gpt_tiny(), device="cpu")
eng = LLMEngine(m, max_batch=2, block_size=16, max_model_len=64,
                prompt_quantum=16, decode_chunk=2, device="cpu")
res = eng.generate([np.arange(5, dtype=np.int32)], max_new_tokens=3)
assert len(res[0].output_ids) == 3
bad = [k for k in sys.modules
       if k == "jax" or k.startswith("jax.") or k == "paddle_tpu"
       or k.startswith("paddle_tpu.")]
print("LOADED", bad)
"""


def test_serving_in_a_fresh_process_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _SERVE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_sources_import_no_jax_or_paddle_tpu():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    pat = re.compile(r"import jax|from jax|(import|from) paddle_tpu\b"
                     r"|paddle_tpu\.")
    for f in files:
        text = f.read_text()
        hits = [m.group(0) for m in pat.finditer(text)]
        assert not hits, f"{f.relative_to(ROOT)}: {hits}"


def test_entry_points_need_cuda_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(gpt_tiny())
    m = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(m, np.zeros((1, 4), np.int32), max_new_tokens=2)
