"""Serving launcher: one batch of requests, prefilled then decoded greedily,
on the card (``--device cpu`` for the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2_9b \\
        --batch 2 --prompt-len 6144 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe_1b_7b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch whisper_large_v3 --batch 8 --prompt-len 224 --gen 32

Any config ``models/model.py::check_served`` accepts is served (pixtral
from tokens alone, as the reference's launcher serves it).  Weights are
random, from seed 0; the prompts are random tokens from seed 1 (the
seeds the reference's launcher uses), and Whisper's (stubbed) audio
frames, (B, encoder_seq, d_model), are ``N(0, 1) * 0.1`` from the same
generator after them, as the reference launcher draws them.  The reference's
launcher (``repro/launch/serve.py``) feeds the prompt one token at a time
through ``decode_step``; this one prefills it with ``prefill`` (one pass
over the prompt, which on the card runs the SSD and flash-attention
kernels) and then decodes, as the reference's ``serve/steps.py`` prefill
step does.  Prints the timings and returns them with the generated
tokens.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke
from ..kernels.flash_attention.kernel import (flash_attention_cuda,
                                              flash_attention_wgmma)
from ..kernels.ssd.kernel import ssd_cuda
from ..models.model import init_model
from ..serve.steps import generate


def _launches() -> Dict[str, int]:
    """Kernel launches so far; "flash" counts both attention kernels (the
    wgmma one takes bfloat16, the TF32 mma.sync one float32)."""
    return {"ssd": ssd_cuda.launches,
            "flash": flash_attention_cuda.launches
            + flash_attention_wgmma.launches}


def serve(cfg, params: Dict, tokens: torch.Tensor, gen: int,
          frames: Optional[torch.Tensor] = None) -> Dict:
    """Generate ``gen`` tokens for each prompt row of ``tokens`` (B, S)
    (Whisper: for each clip of ``frames``) and time it: the prefill's
    wall clock (the encoder's included), each decode step's, and the
    kernel launches of the prefill and of all decode steps (read from the
    wrappers' counts).  Every clock ends in a device synchronisation."""
    dev = tokens.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    marks: List[tuple] = []

    def on_step(kind: str) -> None:
        sync()
        marks.append((time.perf_counter(), _launches()))

    sync()
    start = (time.perf_counter(), _launches())
    out, logits = generate(params, cfg, tokens, gen, on_step=on_step,
                           frames=frames)
    B, S = tokens.shape
    prefill_s = marks[0][0] - start[0]
    steps = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    decode_ms = np.asarray(steps) * 1e3
    end = marks[-1][1]
    pre = {k: marks[0][1][k] - start[1][k] for k in end}
    dec = {k: end[k] - marks[0][1][k] for k in end}
    total_s = marks[-1][0] - start[0]
    return {
        "tokens": out, "logits": logits,
        "prefill_s": prefill_s,
        "prompt_tokens_per_s": B * S / prefill_s,
        "frames_per_s": (None if frames is None
                         else frames.shape[0] * frames.shape[1] / prefill_s),
        "decode_ms": decode_ms.tolist(),
        "decode_ms_p50": float(np.percentile(decode_ms, 50))
        if len(steps) else None,
        "decode_ms_p95": float(np.percentile(decode_ms, 95))
        if len(steps) else None,
        "generated_tokens_per_s": B * gen / total_s,
        "prefill_launches": pre, "decode_launches": dec,
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed runs of the same batch first")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = init_model(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                             generator=gen, device=dev) * 0.1
    for _ in range(args.warmup):
        serve(cfg, params, tokens, args.gen, frames)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    res = serve(cfg, params, tokens, args.gen, frames)
    res["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else None)
    res["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    sample = res["tokens"][0, :12].tolist()
    print(f"{cfg.name} on {res['device']}: batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.gen} new tokens; prefill "
          f"{res['prefill_s']:.4f} s ({res['prompt_tokens_per_s']:.1f} "
          f"prompt tok/s"
          + ("" if frames is None else
             f", {res['frames_per_s']:.1f} audio frames/s") +
          f"), decode p50 {res['decode_ms_p50']} ms, p95 "
          f"{res['decode_ms_p95']} ms per token, "
          f"{res['generated_tokens_per_s']:.1f} generated tok/s")
    print("sample:", sample)
    return res


if __name__ == "__main__":
    main()
