"""dllama_tpu_torch — the PyTorch/CUDA port of ``dllama_tpu``.

A second package beside ``dllama_tpu`` that runs the same `.m`/`.t` files
through PyTorch on an NVIDIA H100.  ``dllama_tpu`` stays the reference:
every module here keeps the name of its counterpart there, and the tests
(``tests/test_torch_*.py``) run both on the same inputs.  This package never
imports ``jax`` or anything of ``dllama_tpu``; what it needs of that
package's jax-free modules (codecs, file formats, tokenizer, host sampler)
is copied here, trimmed to the ported slice.

The slice ported so far is the batch-1 Q40 Llama main path
(``inference`` / ``generate``).  Its one hand-written kernel is the Q40
dequant-matmul (``ops/csrc/q40_matmul.cu``), the twin of the Pallas
``_q40_kernel``/``_stacked_q40_kernel``.

Subpackages
-----------
- ``quants``     — Q40/Q80 block codecs (`.m`-file compatible)
- ``io``         — `.m` model / `.t` tokenizer file formats
- ``tokenizer``  — BPE encode/decode
- ``sampling``   — host sampler + its device twin ``sample_on_device``
- ``ops``        — rmsnorm, RoPE, attention, the Q40 matmul and its kernel
- ``models``     — Llama forward pass over layer-stacked params
- ``runtime``    — engine: prefill/decode, KV cache, generation, G/I/T stats
- ``device``     — device resolution (``cuda`` unless the caller asks for cpu)
"""

__version__ = "0.1.0"
