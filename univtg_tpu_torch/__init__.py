"""PyTorch/CUDA port of univtg_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX reference ``univtg_tpu``: it imports
torch and numpy and nothing of JAX or of the JAX package. This slice serves
the flagship UniVTG grounding model in eval mode; its one hand-written
kernel is the flash-attention forward (``csrc/flash_fwd.cu``).
"""
