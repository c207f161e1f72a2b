"""skinjax_torch — the PyTorch/CUDA port of skinjax for NVIDIA Hopper.

A second package beside ``skinjax``, which stays the reference it is held
against. It imports ``torch`` and never JAX. So far it serves and trains the
flagship (ResNet-50 image tower, one-hot metadata MLP, RG-ATT fusion) and the
same model with a DaViT-tiny tower, with the fusion stage, the augmentation's
color stage and DaViT's window attention in hand-written CUDA kernels
(``skinjax_torch/ops/``, ``skinjax_torch/csrc/``).
"""

# The flagship configuration (the JAX package's __graft_entry__.FLAGSHIP).
FLAGSHIP = dict(
    num_classes=6,
    num_heads=8,
    cnn_model_name="resnet-50",
    text_model_name="one-hot-encoder",
    common_dim=512,
    vocab_size=91,
    attention_mechanism="att-intramodal+residual+cross-attention-metadados",
)

# DaViT-tiny in place of ResNet-50, the configuration whose train rate the JAX
# package's bench.py reports as davit_tiny_images_per_sec (davit_tiny +
# RG-ATT, bf16), at that bench's batch of 64.
DAVIT = dict(FLAGSHIP, cnn_model_name="davit_tiny")
DAVIT_BATCH = 64
