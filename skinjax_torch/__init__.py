"""skinjax_torch — the PyTorch/CUDA port of skinjax for NVIDIA Hopper.

A second package beside ``skinjax``, which stays the reference it is held
against. It imports ``torch`` and never JAX. It serves and trains the
multimodal model with all 18 fusion mechanisms, a one-hot, static-embedding
(model2vec sentence vectors) or TabTransformer (index-encoded columns)
metadata tower and a ResNet-18/50, DaViT-tiny, Swin-tiny, ViT (tiny to large), BEiT-v2-large,
MViTv2-small, CAFormer-s18/b36, CoaT-lite-small, NextViT-small or CNN-zoo
(custom-cnn, VGG16, DenseNet-169, MobileNet-V2, EfficientNet-B0/B7) image tower
(the flagship: ResNet-50 + RG-ATT), trains the sentence datasets' tokens
model (a BERT or GPT-2 tower over tokenized clinical sentences), and runs
the train CLI (``python -m skinjax_torch.tools.train_cli``) from a
PAD-UFES-20 CSV and PNG images on disk to checkpoints the service serves,
with the MD-Net, LiwTERM and MetaNet baselines (``--model-name``) beside the
multimodal model; sequence fusion runs over ViT/BEiT tokens, and the service
batches concurrent requests (``MAX_BATCH``). The NAS slice
(``skinjax_torch.nas``, ``python -m skinjax_torch.tools.nas_cli``) searches the
DynamicCNN space, training a bucket of candidates as one vmapped masked
supernet.
The fusion stage (K1-K4), the augmentation's color stage (K5), DaViT's and
Swin's window attention (K7, on the map and on partitioned windows), DaViT's
channel attention (K8, forward and backward), MViTv2's pooled attention (K11, forward and backward),
the global attention core of ViT, BEiT, CAFormer, BERT and GPT-2 (K12,
forward and both backwards) and the fused token MLPs of CoaT-lite (K9) and
CAFormer (K10), forward and recompute backward, and train-mode BatchNorm's
statistics and backward sums (K6, where a tower's BatchNorms are fused), run in
hand-written CUDA kernels
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

# BEiT-v2-large in place of ResNet-50, the largest published backbone, whose
# train rate bench.py reports as beitv2_large_images_per_sec (bf16, RG-ATT),
# at that bench's batch of 32.
BEIT = dict(FLAGSHIP, cnn_model_name="beitv2_large_patch16_224")
BEIT_BATCH = 32

# MViTv2-small in place of ResNet-50, the second-best published backbone,
# whose train rate bench.py reports as mvitv2_small_images_per_sec (bf16,
# RG-ATT), at that bench's batch of 64.
MVIT = dict(FLAGSHIP, cnn_model_name="mvitv2_small")
MVIT_BATCH = 64

# CAFormer-b36 and CoaT-lite-small in place of ResNet-50, whose train rates
# bench.py reports as caformer_b36_images_per_sec (B=32) and
# coat_lite_small_images_per_sec (B=64), bf16, RG-ATT.
# Swin-tiny in place of ResNet-50, whose train rate bench.py reports as
# swin_tiny_images_per_sec (bf16, RG-ATT), at that bench's batch of 64.
SWIN = dict(FLAGSHIP, cnn_model_name="swin_tiny_patch4_window7_224")
SWIN_BATCH = 64

CAFORMER = dict(FLAGSHIP, cnn_model_name="caformer_b36")
CAFORMER_BATCH = 32
COAT = dict(FLAGSHIP, cnn_model_name="coat_lite_small")
COAT_BATCH = 64

# NextViT-small and DenseNet-169 in place of ResNet-50, the BatchNorm towers
# (the best published backbone of the reference's table after the ported
# ones, and its most BatchNorm-heavy one), bf16, RG-ATT, at the batch of 64
# that bench.py gives its towers of that size; chip_smoke.py reports their
# train rates as nextvit_small_images_per_sec and densenet169_images_per_sec.
# Their train-mode BatchNorms go through K6 where the tower is fused
# (``ops.batch_norm.fuse_batch_norms``).
NEXTVIT = dict(FLAGSHIP, cnn_model_name="nextvit_small")
NEXTVIT_BATCH = 64
DENSENET = dict(FLAGSHIP, cnn_model_name="densenet169")
DENSENET_BATCH = 64

# The sentence datasets' model: DaViT-tiny + a BERT-base tokens tower + RG-ATT
# (the JAX package's bench.py sentence configuration), bf16, at its batch of
# 32. It trains unfrozen at the reference's max_length of 512 tokens, and with
# the text tower frozen (the reference's default) at 256, the length bench.py
# reports sentence_frozen_images_per_sec at. GPT2 is the same model with the
# GPT-2 small tower.
SENTENCE = dict(DAVIT, text_model_name="bert-base-uncased")
GPT2 = dict(DAVIT, text_model_name="gpt2")
SENTENCE_BATCH = 32
SENTENCE_TOKENS = 512
SENTENCE_FROZEN_TOKENS = 256
