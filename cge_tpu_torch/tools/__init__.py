"""Kernel-tuning entry points of the port, each run as
`python -m cge_tpu_torch.tools.<name>` from the repository root:

  sweep_grid     the cluster walk over C x BR x shared_origin x refine
                 (counterpart of tools/tune_sweep.py);
  dragon_grid    clusters per visit and refine on the dragon stand-in,
                 checked against the brute-force sweep (tools/exp_r5_dragon.py);
  mxu_grid       K2's tensor-core mode against the default walk, and the
                 render's trace_chunk sweep (tools/tune_mxu.py);
  stream_layout  streaming bandwidth of the tile layouts through K4
                 (tools/exp_dma_layout.py);
  kernel_bench   K1, K2 (its default walk and mxu mode) and K3 on the main
                 path's batches against their twins, with their bounds,
                 and every compiled shape;
  sass_count     K1's inner loops counted by instruction kind from the
                 built library's SASS (the card's machine only);
  frame_profile  a frame's device time op by op: wall and device-op ms,
                 the device busy share, the top ops, the labelled parts
                 (tools/xprof_dragon.py, tools/profile_bench.py).

All but sass_count take `--device cpu` and small sizes for a run on the
plain twins, which reports no times. Beside them, roofline.py holds the
bounds, op_diff.py finds the first op at which two runs of the same
code (the card and the CPU twins) part, and golden_replay.py replays the
compiled intersection library's cases (tests/golden/golden_intersect.bin)
through the primitives, K3 and K1 + sort + K2.
"""
