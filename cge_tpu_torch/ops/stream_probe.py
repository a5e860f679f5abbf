"""Double-buffered streaming sum: the bandwidth probe (counterpart of the
Pallas kernel of tools/exp_dma_layout.py:28-62, K4).

The TPU kernel streams a [L, sub, w] f32 stack through a two-slot buffer,
SC_N rows per step, and adds each step's rows into a [w] accumulator:
n = L // SC_N steps, so the trailing L % SC_N rows are never read. Its time
is the device's streaming bandwidth for the stack's layout, which is what
the probe measures (cge_tpu_torch.tools.stream_layout).

`stream_sum` launches the CUDA kernel (csrc/stream_probe.cu) for a CUDA
tensor and runs the plain twin `stream_sum_plain` for a CPU tensor; there
is no fallback between the two. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import torch

from cge_tpu_torch import _kernels

SC_N = 4               # rows per step, as in the TPU probe
THREADS = 256          # csrc/stream_probe.cu's SP_THREADS
BLOCKS_PER_SM = 3      # resident blocks per SM at 64 KB of buffer each

LAUNCHES = {"stream_probe": 0}


def stream_sum_plain(stack):
    """Plain twin: the sum of the first (L // SC_N) * SC_N rows over the
    first two axes, [1, w]."""
    n = stack.shape[0] // SC_N
    return stack[:n * SC_N].sum(dim=(0, 1))[None]


def stream_bytes(stack) -> int:
    """Bytes one stream_sum call reads: the rows of whole steps."""
    L, sub, w = stack.shape
    return (L // SC_N) * SC_N * sub * w * stack.element_size()


@torch.no_grad()
def stream_sum(stack):
    """K4: [1, w] sum of a [L, sub, w] f32 stack's whole steps. CUDA
    tensors launch the kernel, which needs w to divide 256 and a 16-byte
    aligned, contiguous stack; CPU tensors run the twin."""
    if stack.device.type == "cpu":
        return stream_sum_plain(stack)
    if stack.device.type != "cuda":
        raise ValueError(f"stream_sum: unsupported device {stack.device}")
    if (stack.dtype != torch.float32 or stack.dim() != 3
            or not stack.is_contiguous() or stack.data_ptr() % 16):
        raise ValueError(f"stream_sum: need a contiguous, 16-byte aligned "
                         f"3-d float32 stack, got {stack.dtype} "
                         f"{tuple(stack.shape)}")
    L, sub, w = stack.shape
    if w == 0 or THREADS % w:
        raise ValueError(f"stream_sum: w must divide {THREADS}, got {w}")
    n_steps = L // SC_N
    out = torch.zeros((1, w), dtype=torch.float32, device=stack.device)
    if n_steps == 0 or sub == 0:
        return out
    sms = torch.cuda.get_device_properties(stack.device).multi_processor_count
    per_block = -(-n_steps // min(n_steps, BLOCKS_PER_SM * sms))
    n_blocks = -(-n_steps // per_block)
    partial = torch.empty((n_blocks, w), dtype=torch.float32,
                          device=stack.device)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(stack.device).cuda_stream
    lib.check(lib.cge_stream_sum(stack.data_ptr(), partial.data_ptr(),
                                 out.data_ptr(), SC_N * sub * w, n_steps,
                                 per_block, n_blocks, w, stream),
              "cge_stream_sum")
    LAUNCHES["stream_probe"] += 1
    return out
