"""The port's offline tools: twins of the JAX package's tools/ scripts that
read the port's own artifacts (its torch.profiler traces, run logs, model
files and work account). Each runs as ``python -m
cxxnet_tpu_torch.tools.<name>``:

summarize_trace   <- tools/summarize_trace.py (torch.profiler Chrome traces)
telemetry_report  <- tools/telemetry_report.py (the JSONL run logs)
roofline          <- tools/roofline.py (FLOPs per sample, MFU, decode bound)
ckpt_fsck         <- tools/ckpt_fsck.py (model-file integrity)
im2bin            <- tools/im2bin.py (an image list packed into BinaryPages)
imgbin_partition_maker <- tools/imgbin_partition_maker.py (worker shards)

tools/bench_compare.py has no twin: it reads bench JSON lines and nothing
of either package.
"""
