"""Hand-written Hopper kernels (sources in ../csrc) and their wrappers.

K1 (kernels/jv.py, csrc/jv.cu): square JV assignment. K2
(kernels/jv_rect.py, csrc/jv_rect.cu): batched rectangular JV assignment.
K3 (kernels/csp.py, csrc/csp.cu): fused YOLOX CSPLayer. K4
(kernels/vit_attention.py, csrc/vit_attention.cu): KPR's ViT attention.
Each wrapper runs its plain version on CPU tensors and launches its kernel
on CUDA tensors; kernels build with nvcc at first use (kernels/_build.py).
"""
