"""Runnable examples of the port, each a module with a ``main()`` that
takes the corpus size and the torch device (``cuda`` by default):

  python -m spmv_topk_tpu_torch.examples.quickstart [--rows N] [--device cpu]
  python -m spmv_topk_tpu_torch.examples.mtx_search matrix.mtx [k]
  python -m spmv_topk_tpu_torch.examples.multihost

Importing one runs nothing."""
