"""Model families (GPT, BERT / ERNIE)."""
from .bert import Bert, BertConfig, Ernie, bert_base, bert_tiny, ernie_base
from .gpt import GPT, GPTConfig, gpt2_124m, gpt2_345m, gpt3_1p3b, gpt_tiny

__all__ = ["GPT", "GPTConfig", "gpt2_124m", "gpt2_345m", "gpt3_1p3b",
           "gpt_tiny", "Bert", "BertConfig", "bert_base", "bert_tiny",
           "Ernie", "ernie_base"]
