"""Serving launcher: batched autoregressive generation.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --full --rff --batch 4 --prompt-len 16 --tokens 32

The flags of ``repro.launch.serve``, plus ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch path). ``--arch`` takes any of the
ten archs of ``repro_torch.configs.ARCH_IDS``. ``--rff`` switches the arch
to the paper's fixed-size-state attention. Weights and prompt are random
from seed 0, the sampler from seed 1.
"""
import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--rff", action="store_true",
                    help="use RFF fixed-state attention (paper technique)")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, with_rff_attention
    from repro_torch.serve.serve_loop import generate

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.rff:
        cfg = with_rff_attention(cfg)

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(gen, cfg, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    sampler = torch.Generator(device=device).manual_seed(1)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = generate(params, cfg, prompt, steps=args.tokens,
                       max_len=args.max_len, temperature=args.temperature,
                       generator=sampler)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} mixer={cfg.mixer} attention={cfg.attention} "
          f"device={device}")
    print(f"{args.batch}x{args.tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.tokens / dt:.1f} tok/s)")
    print("sample:", out[0][:16].tolist())


if __name__ == "__main__":
    main()
