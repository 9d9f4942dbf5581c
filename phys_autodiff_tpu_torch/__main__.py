"""`python -m phys_autodiff_tpu_torch <command>`: the port's CLI (cli.py)."""

from phys_autodiff_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
