"""``test_torch_families.py``'s parity tests over the RGB + depth
``llama_ens5_2images`` and the text-only ``llama`` (a decoder of its own
with grouped-query attention and rope theta 1e6, from a config file both
constructors read). Same weights, inputs and tolerances as there; the
image tests of ``llama`` hold the refusals instead (the JAX method has no
towers to call)."""

import pytest

from test_torch_families import (  # noqa: F401 (tests and fixtures)
    dense,
    int4,
    test_compute_logits_match,
    test_forward_loss_matches,
    test_generate_greedy_identical,
    test_image_tokens_match,
    test_int4_prefill_logits_match,
    test_load_lora_and_adapter_checkpoint_match_jax,
    test_masks_and_blocklist_equal_jax,
    test_prefill_and_decode_logits_match,
    test_stream_generate_ends_as_generate,
)


@pytest.fixture(scope="module", params=["llama_ens5_2images", "llama"])
def family(request):
    return request.param
