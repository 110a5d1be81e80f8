"""The program under test (``a3vlm_tpu_torch``): one module a model family
builds it from a configuration and the benchmark's weights
(``build``); ``common.run_batch`` drives one static batch."""
