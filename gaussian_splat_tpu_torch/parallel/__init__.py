"""Multi-device rendering and training over `torch.distributed`.

Counterpart of gaussian_splat_tpu/parallel/: splat-parallel projection, one
exchange of 13-float records, tile-parallel rasterization by horizontal bands,
and the gradient's way back through the same exchange. One process drives one
device (a rank); `mesh.make_mesh` joins them into a 1-D `DeviceMesh` named
"dev", NCCL between CUDA devices and gloo between CPU processes.
"""
