"""The benchmark of the PyTorch port (``a3vlm_tpu_torch``); see README.md."""
