"""The measurement labs of ``experiments/`` on the H100, one module per lab
under the same name: ``kernel_lab`` (L7), ``fused_lab`` (L4), ``h16_lab``
(L5), ``fold_lab`` (L3), ``batch_lab`` (L1), ``dma_lab`` (L2),
``i16_probe`` (L6), ``mxu_gather_lab`` (L8) and ``pack16_lab`` (L9).
Each runs over the lab's own data, through a CUDA kernel of
``csrc/lab_*.cu`` on a CUDA tensor (its plain PyTorch version on a CPU
tensor), and its ``main()`` times every variant, the streaming labs
beside the stream probe K3 on the same words:

    python -m spmv_topk_tpu_torch.experiments.kernel_lab f32 h16
    python -m spmv_topk_tpu_torch.experiments.kernel_lab --device cpu

``k6_h16_ablation`` and ``k1_octet_cost`` time a production kernel (K6
h16, K1) against copies of its source with a part taken out or a
constant changed, built beside the package's library; they need a card.

Importing a lab parses no arguments and needs no card.
"""
