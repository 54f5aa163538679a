"""PyTorch port of the OSDT block-diffusion decoder (dense family).

The JAX/Pallas package ``repro`` is the reference; this package mirrors its
module names and public layouts so the two can be compared on the same
inputs. It imports neither ``jax`` nor anything of ``repro``. Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
