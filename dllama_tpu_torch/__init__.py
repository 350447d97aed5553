"""dllama_tpu_torch — the PyTorch/CUDA port of ``dllama_tpu``.

A second package beside ``dllama_tpu`` that runs the same `.m`/`.t` files
through PyTorch on an NVIDIA H100.  ``dllama_tpu`` stays the reference:
every module here keeps the name of its counterpart there, and the tests
(``tests/test_torch_*.py``) run both on the same inputs.  This package never
imports ``jax`` or anything of ``dllama_tpu``; what it needs of that
package's jax-free modules (codecs, file formats, tokenizer, host sampler)
is copied here, trimmed to the ported slice.

Ported so far: every CLI mode of the JAX package but ``worker``, the API
server and the fleet (``router``, ``serve-pod``).  Every Pallas kernel of
the JAX package has a hand-written CUDA twin in ``ops/csrc/``, beside the
port's own kernel for attention over the paged pool at t > 1.

Subpackages
-----------
- ``quants``     — Q40/Q80 block codecs (`.m`-file compatible)
- ``io``         — `.m` model / `.t` tokenizer file formats
- ``tokenizer``  — BPE encode/decode
- ``sampling``   — host sampler + its device twin ``sample_on_device``
- ``ops``        — rmsnorm, RoPE, attention, the Q40 matmul and its kernel
- ``models``     — Llama forward pass over layer-stacked params
- ``runtime``    — engine: prefill/decode, KV cache, generation, G/I/T stats;
  the slot scheduler, snapshots, speculation, fault points
- ``server``     — the OpenAI-compatible API server
- ``router``     — the fleet router and ``serve-pod`` (replicas behind it)
- ``obs``        — metrics, logs, spans, flight records, SLOs, the roofline
- ``device``     — device resolution (``cuda`` unless the caller asks for cpu)
"""

__version__ = "0.1.0"
