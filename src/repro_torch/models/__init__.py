"""Language-model stack of the PyTorch port (counterpart of
``repro.models``): the dense and MoE transformer blocks the serving slice
runs, with prefill attention through the flash-attention kernel and the
MoE expert FFN through the grouped-matmul kernel."""
