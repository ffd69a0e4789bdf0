"""The port's device rule: entry points run on the card unless the caller
asks for the CPU, and never carry on on the CPU by themselves; a kernel
wrapper takes its plain version for a CPU tensor only, and a CUDA launcher
rejects what its kernel does not take before touching the card."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_spec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mla_attention import flash_attention_cuda  # noqa: E402,E501
from repro_torch.kernels.moe_gmm import gmm_cuda  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import resolve_device  # noqa: E402

SPEC = get_spec("deepseek-v3", smoke=True)


def test_build_model_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(SPEC)
    assert resolve_device("cpu") == torch.device("cpu")
    m = build_model(SPEC, device="cpu")
    assert next(m.parameters()).device.type == "cpu"


def test_wrappers_reject_other_devices():
    x = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain version"):
        ops.rmsnorm(x, torch.empty(64, dtype=torch.bfloat16, device="meta"))


def test_plain_path_does_not_count_launches():
    before = ops.launch_counts()
    x = torch.randn(4, 64).to(torch.bfloat16)
    ops.rmsnorm(x, torch.ones(64, dtype=torch.bfloat16))
    assert ops.launch_counts() == before


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(ops.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda-home")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops._nvcc()


@pytest.mark.parametrize("case", ["dtype", "scale_shape"])
def test_rmsnorm_launcher_validates(case):
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    scale = torch.ones(64, dtype=torch.bfloat16)
    if case == "dtype":
        with pytest.raises(TypeError, match="bfloat16"):
            rmsnorm_cuda(None, x.float(), scale, eps=1e-6, gemma_style=False)
    else:
        with pytest.raises(ValueError, match="scale"):
            rmsnorm_cuda(None, x, scale[:32], eps=1e-6, gemma_style=False)


@pytest.mark.parametrize("case", ["head_dim", "shape", "layout"])
def test_flash_launcher_validates(case):
    q = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 2, 32), dtype=torch.bfloat16)
    if case == "head_dim":
        q = torch.zeros((1, 8, 2, 40), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="multiple of 16"):
            flash_attention_cuda(None, q, q, v, scale=1.0, causal=True)
    elif case == "shape":
        with pytest.raises(ValueError, match="shapes"):
            flash_attention_cuda(None, q, q[:, :4], v, scale=1.0, causal=True)
    else:
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention_cuda(None, q, q, v.transpose(2, 3).contiguous()
                                 .transpose(2, 3), scale=1.0, causal=True)


@pytest.mark.parametrize("case", ["block_m", "map_dtype", "map_len"])
def test_gmm_launcher_validates(case):
    lhs = torch.zeros((80, 64), dtype=torch.bfloat16)
    rhs = torch.zeros((2, 64, 32), dtype=torch.bfloat16)
    emap = torch.zeros(2, dtype=torch.int32)
    if case == "block_m":
        with pytest.raises(ValueError, match="block_m"):
            gmm_cuda(None, lhs, rhs, emap, block_m=30)
    elif case == "map_dtype":
        with pytest.raises(TypeError, match="expert_map"):
            gmm_cuda(None, lhs, rhs, emap.long(), block_m=40)
    else:
        with pytest.raises(ValueError, match="expert_map"):
            gmm_cuda(None, lhs, rhs, emap[:1], block_m=40)
