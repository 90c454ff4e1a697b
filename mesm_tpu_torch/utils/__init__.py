from .checkpoint import count_parameters, load_checkpoint, save_checkpoint
from .io import load_json, save_json, load_jsonl, save_jsonl, dict_to_markdown, mkdirp
from .meters import AverageMeter
