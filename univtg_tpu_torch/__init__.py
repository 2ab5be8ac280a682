"""PyTorch/CUDA port of univtg_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference ``univtg_tpu``: it imports
torch and numpy and nothing of JAX or of the JAX package. It serves the
flagship UniVTG grounding model (``cli serve``), trains it (``cli
train-mr``), evaluates it (``cli infer-mr``, ``cli eval``) and stores it in
int8 (``cli quantize``). Its hand-written kernels are the flash-attention
forward and backward (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), the
int8 dequant-matmul (``csrc/int8_matmul.cu``) and context-parallel ring
attention (``csrc/ring_attention.cu``, run inside ``parallel.use_ring``);
its host kernels, built with g++, are batched detection AP and the npz
feature reader (``native/``). ``cli pack-h5`` packs whole-split h5 feature
caches.
"""
