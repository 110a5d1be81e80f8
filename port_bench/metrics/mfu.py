"""Model FLOPs utilisation of the window, in %: the FLOPs the completed
batches' inputs need (``arch.<family>.batch_flops``: a distinct image
once, each prompt and generated id once through the decoder with its
attention, the head once a generated id) over their host seconds times
the card's bf16 peak."""

from port_bench.peaks import PEAK_FLOPS


def read(run):
    b = run["batches"]
    flops = sum(run["arch"].batch_flops(run["cfg"], x["prompt_lens"],
                                        x["gen_lens"], x["distinct_images"])
                for x in b)
    return 100.0 * flops / (sum(x["seconds"] for x in b) * PEAK_FLOPS)
