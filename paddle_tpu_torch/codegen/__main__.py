"""CLI: python -m paddle_tpu_torch.codegen [--check]"""
import sys

from .generate import generate_all

if __name__ == "__main__":
    if "--check" in sys.argv:
        print(f"generated files in sync for {generate_all(check=True)} ops")
    else:
        print(f"generated wrappers/registry/methods/stub for "
              f"{generate_all()} ops")
