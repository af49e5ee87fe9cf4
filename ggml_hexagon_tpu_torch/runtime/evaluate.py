"""Quality evaluation: perplexity, KL-divergence, imatrix collection and
multiple-choice scoring.

Counterpart of ggml_hexagon_tpu/runtime/evaluate.py.  Perplexity follows
the reference protocol (examples/perplexity/perplexity.cpp:460-650): the
corpus is split into non-overlapping n_ctx chunks, BOS replaces each
chunk's first token, and NLL is accumulated only over the second half of
each window; ppl = exp(sum nll / n) with its standard error from sum
nll^2.  KL-divergence compares two models' distributions position by
position; imatrix accumulates per-input-column sums of x^2 and counts for
every quantized matmul through the forward's tap; HellaSwag, Winogrande
and MMLU-class tasks score each candidate by the mean log-probability of
its tokens.

Each chunk runs one forward with logits_all on the device (K3 on every
projection and on the head above 8 tokens, K1 at <= 8); the [T, V]
log-softmax stays there, and only what the caller uses comes back to the
host: the [T-1] target log-probabilities, or one KL value a position.
Functions take the port's (cfg, weights), the weights on `device`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models.llama import forward, init_kv_cache


@dataclass
class PerplexityResult:
    ppl: float
    err: float  # standard error of ln(ppl)
    nll_sum: float
    nll_count: int
    chunk_ppls: list = field(default_factory=list)

    def __str__(self):
        return f"PPL = {self.ppl:.4f} +/- {self.ppl*self.err:.4f}"


def chunk_logits(cfg, weights, chunk_ids, compute_dtype=torch.bfloat16,
                 device="cuda", plain: bool = False, tap=None):
    """The f32 logits [T, V] of one chunk, on the device: one forward over
    the chunk from an empty bf16 cache with logits_all."""
    dev = resolve_device(device)
    ids = torch.as_tensor(np.asarray(chunk_ids, np.int64)[None], device=dev)
    kv = init_kv_cache(cfg, 1, ids.shape[1], "bf16", dev)
    logits, _ = forward(cfg, weights, ids, kv, 0, logits_all=True,
                        compute_dtype=compute_dtype, plain=plain, tap=tap)
    return logits[0]


def _chunk_logprobs(cfg, weights, chunk_ids, compute_dtype=torch.bfloat16,
                    device="cuda", plain: bool = False):
    """Token logprobs for one chunk: ([T-1] logprob of each next token, as
    numpy; the [T, V] log-softmax, a device tensor)."""
    lp = torch.log_softmax(chunk_logits(cfg, weights, chunk_ids,
                                        compute_dtype, device, plain), dim=-1)
    nxt = torch.as_tensor(np.asarray(chunk_ids[1:], np.int64),
                          device=lp.device)
    return lp[:-1].gather(1, nxt[:, None])[:, 0].cpu().numpy(), lp


def perplexity(cfg, weights, tokens, n_ctx: int = 512,
               bos_id: int | None = 1, compute_dtype=torch.bfloat16,
               progress=None, device="cuda",
               plain: bool = False) -> PerplexityResult:
    """The reference protocol (perplexity.cpp:460-650): the corpus stream
    carries one leading BOS; each n_ctx chunk is evaluated with its first
    token replaced by BOS, and NLL covers chunk positions first+1 ..
    n_ctx-1 (first = n_ctx // 2)."""
    tokens = ([bos_id] + list(tokens)) if bos_id is not None else list(tokens)
    n_chunk = len(tokens) // n_ctx
    if n_chunk < 1:
        raise ValueError(f"need >= {n_ctx} tokens, have {len(tokens)}")
    first = n_ctx // 2
    nll = 0.0
    nll2 = 0.0
    count = 0
    chunk_ppls = []
    for c in range(n_chunk):
        chunk = tokens[c * n_ctx:(c + 1) * n_ctx]
        if bos_id is not None:
            chunk = [bos_id] + chunk[1:]
        lps, _ = _chunk_logprobs(cfg, weights, chunk, compute_dtype, device,
                                 plain)
        # lps[j] scores chunk[j+1]; targets are positions first+1..n_ctx-1
        for v in lps[first:]:
            nll += -float(v)
            nll2 += float(v) * float(v)
            count += 1
        chunk_ppls.append(math.exp(nll / count))
        if progress:
            progress(c + 1, n_chunk, chunk_ppls[-1])
    mean = nll / count
    var = nll2 / count - mean * mean
    err = math.sqrt(max(var, 0.0) / count)
    return PerplexityResult(math.exp(mean), err, nll, count, chunk_ppls)


def kl_divergence(cfg_base, weights_base, cfg_test, weights_test, tokens,
                  n_ctx: int = 512, bos_id: int | None = 1,
                  compute_dtype=torch.bfloat16, device="cuda") -> dict:
    """Mean KL(base || test) per token + same-top-1 rate; each position's
    KL is computed on the device and only [T] values a chunk come back."""
    tokens = list(tokens)
    n_chunk = len(tokens) // n_ctx
    kls = []
    same_top = 0
    total = 0
    for c in range(n_chunk):
        chunk = tokens[c * n_ctx:(c + 1) * n_ctx]
        if bos_id is not None:
            chunk = [bos_id] + chunk[:-1]
        _, lp_b = _chunk_logprobs(cfg_base, weights_base, chunk,
                                  compute_dtype, device)
        _, lp_t = _chunk_logprobs(cfg_test, weights_test, chunk,
                                  compute_dtype, device)
        kl = (torch.exp(lp_b) * (lp_b - lp_t)).sum(dim=-1)
        kls.extend(kl.cpu().numpy().tolist())
        same_top += int((lp_b.argmax(-1) == lp_t.argmax(-1)).sum())
        total += lp_b.shape[0]
    kls = np.asarray(kls)
    return {"kld_mean": float(kls.mean()), "kld_max": float(kls.max()),
            "same_top1": same_top / total, "n": total}


class IMatrixCollector:
    """Accumulates per-column sums of x^2 for each quantized matmul input.

    Expert (MUL_MAT_ID) tensors accumulate per-expert slices: entry shape
    [E, C] with per-expert routed-token counts, stored expert-major [E*C]
    (imatrix.cpp:104-169).  The sums build on the device during a chunk
    and come to the host once a chunk; save() writes the JAX package's
    .npz (means, and "__count__<name>" entries), which its
    IMatrixCollector.load reads, and load() reads either package's."""

    def __init__(self, cfg, weights, compute_dtype=torch.bfloat16,
                 device="cuda", plain: bool = False):
        self.cfg = cfg
        self.weights = weights
        self.sums: dict[str, np.ndarray] = {}
        self.counts: dict = {}  # name -> int (dense) | np.ndarray [E] (MoE)
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.plain = plain

    def process_chunk(self, chunk_ids):
        T = len(chunk_ids)
        taps = {}
        ecnt = {}  # expert entries: per-expert routed-token counts

        def tap(name, x, expert=None):
            if name.endswith(".l_out"):  # layer states: not an imatrix entry
                return
            C = x.shape[-1]
            x2 = x.to(torch.float32).reshape(-1, C) ** 2
            if expert is None:
                s = x2.sum(dim=0)
                taps[name] = taps[name] + s if name in taps else s
                return
            e, E, sel = expert
            selr = sel.to(torch.float32).reshape(-1)
            if name not in taps:
                taps[name] = torch.zeros(E, C, dtype=torch.float32,
                                         device=x.device)
                ecnt[name] = torch.zeros(E, dtype=torch.float32,
                                         device=x.device)
            taps[name][e] += (x2 * selr[:, None]).sum(dim=0)
            ecnt[name][e] += selr.sum()

        chunk_logits(self.cfg, self.weights, chunk_ids, self.compute_dtype,
                     self.device, self.plain, tap=tap)
        for name, s in taps.items():
            s = s.cpu().numpy()
            c = ecnt[name].cpu().numpy() if name in ecnt else T
            if name in self.sums:
                self.sums[name] += s
                self.counts[name] += c
            else:
                self.sums[name] = s
                self.counts[name] = c

    def result(self) -> dict[str, np.ndarray]:
        """name -> mean x^2 per column (what quantize feeds as
        quant_weights); expert entries flatten expert-major [E*C]."""
        out = {}
        for n, s in self.sums.items():
            c = self.counts[n]
            if isinstance(c, np.ndarray):  # per-expert [E] counts
                out[n] = (s / np.maximum(c, 1.0)[:, None]).reshape(-1)
            else:
                out[n] = s / max(1, c)
        return out

    def save(self, path: str):
        np.savez(path, **{n: v for n, v in self.result().items()},
                 **{f"__count__{n}": np.asarray(c)
                    for n, c in self.counts.items()})

    @staticmethod
    def load(path: str) -> dict[str, np.ndarray]:
        z = np.load(path)
        return {n: z[n] for n in z.files if not n.startswith("__count__")}


# ---------------------------------------------------------------------------
# Multiple-choice benchmark scoring (HellaSwag / Winogrande / MMLU-class),
# the protocols of examples/perplexity/perplexity.cpp: hellaswag_score
# (:741-997), winogrande_score (:1084-1292), multiple_choice_score
# (:1388-1669).  Each candidate continuation is scored by the mean token
# log-probability of its tokens past the common prefix (the first
# continuation token from the last prefix logit); the candidate with the
# largest mean wins.  Each candidate runs one forward of its own.
# ---------------------------------------------------------------------------


@dataclass
class ScoreResult:
    n_done: int
    n_correct: int

    @property
    def acc(self) -> float:
        return self.n_correct / self.n_done if self.n_done else 0.0

    @property
    def sigma(self) -> float:
        """100 * sqrt(p(1-p)/(n-1)), the reference's reported error."""
        if self.n_done < 2:
            return 0.0
        p = self.acc
        return 100.0 * math.sqrt(p * (1 - p) / (self.n_done - 1))

    def __str__(self):
        return f"{100*self.acc:.4f} +/- {self.sigma:.4f} ({self.n_done} tasks)"


def _mean_continuation_logprob(cfg, weights, ids, start: int, end: int,
                               compute_dtype, device):
    """Mean logprob of tokens ids[start:end] given their prefixes."""
    lps, _ = _chunk_logprobs(cfg, weights, ids, compute_dtype, device)
    span = lps[start - 1:end - 1]
    return float(np.sum(span)) / max(len(span), 1)


def _common_prefix(seqs) -> int:
    cp = 0
    for toks in zip(*seqs):
        if any(t != toks[0] for t in toks):
            break
        cp += 1
    return min(cp, min(len(s) for s in seqs) - 1)


def choice_scores(cfg, weights, context, cands, tokenizer, bos: bool = True,
                  compute_dtype=torch.bfloat16, device="cuda",
                  joiner: str = " ") -> list:
    """The mean continuation logprob of each candidate of one task."""
    seqs = [tokenizer.encode(context + joiner + c, add_bos=bos)
            for c in cands]
    cp = _common_prefix(seqs)
    return [_mean_continuation_logprob(cfg, weights, s, cp, len(s),
                                       compute_dtype, device) for s in seqs]


def score_choice_tasks(cfg, weights, tasks, tokenizer, bos: bool = True,
                       compute_dtype=torch.bfloat16, progress=None,
                       joiner: str = " ", device="cuda") -> ScoreResult:
    """tasks: [(context, [candidates...], gold_idx)].  The hellaswag /
    multiple-choice scoring core (acc_norm: mean-logprob argmax)."""
    res = ScoreResult(0, 0)
    for context, cands, gold in tasks:
        scores = choice_scores(cfg, weights, context, cands, tokenizer, bos,
                               compute_dtype, device, joiner)
        res.n_done += 1
        res.n_correct += int(int(np.argmax(scores)) == gold)
        if progress:
            progress(res)
    return res


def parse_hellaswag(text: str, n_tasks: int | None = None, seed: int = 1):
    """The reference's 6-lines-per-task layout (perplexity.cpp:752-761):
    context / gold index / 4 endings; a random subset of n_tasks (the JAX
    package's Python PRNG stream)."""
    import random

    lines = text.splitlines()
    if len(lines) % 6:
        raise ValueError("hellaswag input must be 6 lines per task")
    tasks = []
    for i in range(0, len(lines), 6):
        tasks.append((lines[i], lines[i + 2:i + 6], int(lines[i + 1])))
    if n_tasks is not None and n_tasks < len(tasks):
        rng = random.Random(seed)
        tasks = rng.sample(tasks, n_tasks)
    return tasks


def hellaswag(cfg, weights, text: str, tokenizer, n_tasks: int | None = None,
              compute_dtype=torch.bfloat16, progress=None,
              device="cuda") -> ScoreResult:
    return score_choice_tasks(cfg, weights, parse_hellaswag(text, n_tasks),
                              tokenizer, compute_dtype=compute_dtype,
                              progress=progress, device=device)


def parse_winogrande_csv(text: str):
    """index,sentence-with-_,choice1,choice2,answer(1|2) CSV
    (load_winogrande_from_csv, perplexity.cpp:1014-1074)."""
    import csv
    import io

    out = []
    for row in csv.reader(io.StringIO(text)):
        if len(row) < 5:
            continue
        _, sentence, c1, c2, ans = row[:5]
        if "_" not in sentence:
            continue
        first, second = sentence.split("_", 1)
        out.append((first, second, c1, c2, int(ans)))
    return out


def winogrande_scores(cfg, weights, entry, tokenizer,
                      compute_dtype=torch.bfloat16, device="cuda") -> list:
    """The two choices' scores of one Winogrande entry: each choice fills
    the blank; the score is the mean logprob of the second sentence part
    after the choice, or of every token past the common prefix when
    either trailing part is k_min_trailing_ctx (3) tokens or shorter; the
    final token is left out when more than one trails
    (perplexity.cpp:1221)."""
    first, second, c1, c2, _ = entry
    K_MIN_TRAILING = 3
    seqs, n_bases = [], []
    for choice in (c1, c2):
        seqs.append(tokenizer.encode(first + choice + second, add_bos=True))
        n_bases.append(len(tokenizer.encode(first + choice, add_bos=True)))
    cp = _common_prefix(seqs)
    skip_choice = all(len(s) - cp > K_MIN_TRAILING for s in seqs)
    scores = []
    for s, n_base in zip(seqs, n_bases):
        start = n_base if skip_choice else cp
        last = 1 if len(s) - start > 1 else 0
        scores.append(_mean_continuation_logprob(
            cfg, weights, s, start, len(s) - last, compute_dtype, device))
    return scores


def winogrande(cfg, weights, text: str, tokenizer, n_tasks: int | None = None,
               compute_dtype=torch.bfloat16, progress=None,
               device="cuda") -> ScoreResult:
    """Winogrande scoring (winogrande_score, perplexity.cpp:1084-1292)."""
    entries = parse_winogrande_csv(text)
    if n_tasks is not None:
        entries = entries[:n_tasks]
    res = ScoreResult(0, 0)
    for entry in entries:
        scores = winogrande_scores(cfg, weights, entry, tokenizer,
                                   compute_dtype, device)
        got = 1 if scores[0] > scores[1] else 2
        res.n_done += 1
        res.n_correct += int(got == entry[4])
        if progress:
            progress(res)
    return res


def parse_multiple_choice(tasks_json, n_tasks: int | None = None):
    """A JSON list of {"question", "answers": [..], "label": gold index
    (0-based)} -> [(question, answers, label)]."""
    import json

    tasks = tasks_json
    if isinstance(tasks, (str, bytes)):
        tasks = json.loads(tasks)
    parsed = [(t["question"], list(t["answers"]), int(t["label"]))
              for t in tasks]
    return parsed[:n_tasks] if n_tasks is not None else parsed


def multiple_choice(cfg, weights, tasks_json, tokenizer,
                    n_tasks: int | None = None,
                    compute_dtype=torch.bfloat16, progress=None,
                    device="cuda") -> ScoreResult:
    """MMLU-class scoring (multiple_choice_score, perplexity.cpp:1388): the
    hellaswag scoring with a variable answer count."""
    return score_choice_tasks(cfg, weights,
                              parse_multiple_choice(tasks_json, n_tasks),
                              tokenizer, compute_dtype=compute_dtype,
                              progress=progress, device=device)
