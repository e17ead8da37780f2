"""Text front-end of the port: normalization, number reading, tokenization."""

from viettts_tpu_torch.text.frontend import (
    load_lexicon,
    normalize_text,
    text_to_tokens,
    tokens_to_ids,
)
from viettts_tpu_torch.text.numbers import expand_numbers, number_to_vietnamese

__all__ = [
    "normalize_text",
    "load_lexicon",
    "text_to_tokens",
    "tokens_to_ids",
    "expand_numbers",
    "number_to_vietnamese",
]
