"""Chat templates + chat stop strings — a copy of ``dllama_tpu/tokenizer/chat.py``.

Behavior-compatible with the reference ``ChatTemplate`` /
``TokenizerChatStops`` (the reference's src/tokenizer.cpp:417-473): the
template *type* is detected by substring match on the Jinja template string
embedded in the `.t` file, and each known type is re-implemented natively.
"""

from __future__ import annotations

from dataclasses import dataclass

from .bpe import Tokenizer

TEMPLATE_LLAMA3 = "llama3"
TEMPLATE_ZEPHYR = "zephyr"
TEMPLATE_CHATML = "chatml"


@dataclass
class ChatItem:
    role: str
    message: str


def detect_template_type(chat_template: str) -> str:
    """Substring-based detection (tokenizer.cpp:440-452)."""
    if "<|start_header_id|>" in chat_template:
        return TEMPLATE_LLAMA3
    if "<|user|>" in chat_template:
        return TEMPLATE_ZEPHYR
    if "<|im_start|>" in chat_template:
        return TEMPLATE_CHATML
    raise ValueError("Not supported chat template")


class ChatTemplate:
    def __init__(self, chat_template: str | None, eos: str):
        if chat_template is None:
            raise ValueError("The tokenizer does not include chat template")
        self.type = detect_template_type(chat_template)
        self.eos = eos

    def generate(self, items: list[ChatItem], append_generation_prompt: bool) -> str:
        """Render messages (tokenizer.cpp:454-473)."""
        out: list[str] = []
        if self.type == TEMPLATE_LLAMA3:
            for it in items:
                out.append(f"<|start_header_id|>{it.role}<|end_header_id|>\n\n{it.message}{self.eos}")
            if append_generation_prompt:
                out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        elif self.type == TEMPLATE_CHATML:
            for it in items:
                out.append(f"<|im_start|>{it.role}\n{it.message}<|im_end|>\n")
            if append_generation_prompt:
                out.append("<|im_start|>assistant\n")
        elif self.type == TEMPLATE_ZEPHYR:
            for it in items:
                out.append(f"<|{it.role}|>\n{it.message}{self.eos}\n")
            if append_generation_prompt:
                out.append("<|assistant|>\n")
        return "".join(out)


class TokenizerChatStops:
    """Stop strings for chat mode (tokenizer.cpp:417-434): the chat-EOS
    token's piece, plus the tokenizer's optional extra stop string."""

    def __init__(self, tokenizer: Tokenizer):
        if tokenizer.chat_eos_id < 0:
            raise ValueError("tokenizer has no chat EOS id; regenerate the .t file")
        stops = [tokenizer.vocab[tokenizer.chat_eos_id].decode("utf-8", errors="replace")]
        if tokenizer.chat_stop:
            stops.append(tokenizer.chat_stop)
        self.stops = stops
        self.max_stop_length = max(len(s) for s in stops)
