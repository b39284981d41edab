"""Serving launcher: batched generation with cached decode (port of
`repro.launch.serve`, the same flags), on the CUDA device.

    python -m repro_torch.launch.serve --arch gemma-2b --smoke --new 16

Parameters are drawn in float32 from a generator seeded 0 on the card,
prompts from the same generator; the compute dtype is float32, as in the
reference. Prints the tokens per second of `generate` (prefill and
decode, the device synchronized) and the first two rows of tokens.
"""
import argparse
import time

import torch

from repro_torch.configs import get_arch, get_smoke
from repro_torch.models import init_params
from repro_torch.precision import FORMAT_ID
from repro_torch.precision.backend import resolve_device
from repro_torch.serve import ServeConfig, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-format", default=None,
                    help="emulated KV-cache format (e.g. e4m3, bf16)")
    args = ap.parse_args(argv)

    dev = resolve_device()
    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, torch.float32, dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    scfg = ServeConfig(max_new_tokens=args.new,
                       temperature=args.temperature,
                       compute_dtype=torch.float32,
                       cache_fmt=FORMAT_ID[args.kv_format]
                       if args.kv_format else None)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    with torch.inference_mode():
        toks = generate(params, prompts, cfg, scfg, gen, dev)
    torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"[serve] {args.batch} seqs x {args.new} new tokens in {dt:.2f}s "
          f"({args.batch * args.new / dt:.1f} tok/s)")
    print(toks[: min(2, args.batch)].cpu())
    return toks


if __name__ == "__main__":
    main()
