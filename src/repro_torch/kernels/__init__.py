# Hand-written Hopper kernels of the port. Each kernel's CUDA source lives
# in repro_torch/csrc/<name>.cu behind a plain C interface; its directory
# here holds kernel.py (ctypes binding), ops.py (the checked public wrapper
# with its launch counter) and ref.py (the plain PyTorch version the CPU
# runs and the card is held against). kernels.build compiles the sources.
#   fused_sgd/         lane-stacked fused momentum-SGD update (the FL inner update)
#   flash_attention/   blockwise causal GQA attention (prefill)
#   decode_attention/  one-query GQA attention over a KV cache (decode)
#   ssd_scan/          Mamba2 SSD chunked scan (SSM prefill)
