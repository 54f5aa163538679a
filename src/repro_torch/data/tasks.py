"""Synthetic task suite standing in for GSM8K / GPQA / HumanEval.

A copy of the reference's ``data/tasks.py`` (numpy only). The paper's
benchmarks are not bundled, so each is represented by a generator of the
same *shape* of problem: step-by-step arithmetic (gsm8k-syn), multi-hop
multiple-choice QA (gpqa-syn), and format-constrained code completion
(humaneval-syn). Exact-match scoring mirrors each benchmark's metric.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np

# Vocabularies are kept SMALL so a ~2M-param byte-level bench model can
# actually master the tasks (the policy comparison needs accuracy in the
# mid-to-high band; the paper compares decoding policies at fixed model
# quality, not absolute capability).
NAMES = ["Tom", "Ana", "Raj", "Mia"]
OBJECTS = ["apples", "coins", "pens"]
PLACES = ["Lund", "Kyoto", "Quito", "Oslo", "Perth", "Reno"]
REGIONS = ["Norra", "Kansai", "Andes", "Viken", "Swan", "Washoe"]
COUNTRIES = ["Sweden", "Japan", "Ecuador", "Norway", "Australia", "USA"]
# fixed world knowledge: PLACES[i] -> REGIONS[i] -> COUNTRIES[i]


@dataclass
class Sample:
    prompt: str
    answer: str


class Task:
    name: str

    def make(self, rng: np.random.Generator, n: int) -> List[Sample]:
        raise NotImplementedError

    @staticmethod
    def extract(text: str) -> str:
        """Answer = generated text up to the first newline, stripped."""
        return text.split("\n")[0].strip()

    def score(self, generated: str, sample: Sample) -> bool:
        return self.extract(generated) == sample.answer.strip()


class Gsm8kSyn(Task):
    name = "gsm8k-syn"

    def make(self, rng, n):
        out = []
        for _ in range(n):
            name = NAMES[rng.integers(len(NAMES))]
            obj = OBJECTS[rng.integers(len(OBJECTS))]
            # single-step small sums: memorisable by the bench model
            a, b = int(rng.integers(2, 10)), int(rng.integers(2, 10))
            q = f"{name} has {a} {obj} and gets {b} more. How many {obj} now?"
            out.append(Sample(f"Q: {q}\nA:", f" {a + b}"))
        return out


class GpqaSyn(Task):
    name = "gpqa-syn"

    def make(self, rng, n):
        out = []
        for _ in range(n):
            i = int(rng.integers(len(PLACES)))
            city, region, country = PLACES[i], REGIONS[i], COUNTRIES[i]
            distract = [COUNTRIES[x] for x in rng.permutation(len(COUNTRIES))
                        if COUNTRIES[x] != country][:3]
            opts = distract + [country]
            order = rng.permutation(4)
            letters = "ABCD"
            correct = letters[int(np.argwhere(order == 3)[0][0])]
            lines = " ".join(f"{letters[p]}) {opts[o]}"
                             for p, o in enumerate(order))
            q = (f"{city} lies in {region}. {region} is part of {country}. "
                 f"Which country contains {city}? {lines}")
            out.append(Sample(f"Q: {q}\nA:", f" {correct}"))
        return out


class HumanevalSyn(Task):
    name = "humaneval-syn"

    def make(self, rng, n):
        out = []
        ops = [("+", lambda x, y: x + y), ("-", lambda x, y: x - y)]
        for _ in range(n):
            op, fn = ops[rng.integers(len(ops))]
            c = int(rng.integers(1, 6))
            v = int(rng.integers(1, 6))
            prompt = (f"def f(x):\n    return x {op} {c}\n"
                      f"assert f({v}) ==")
            out.append(Sample(prompt, f" {fn(v, c)}"))
        return out


TASKS: Dict[str, Task] = {t.name: t for t in
                          (Gsm8kSyn(), GpqaSyn(), HumanevalSyn())}


def mixture(rng: np.random.Generator, n: int) -> List[Sample]:
    """Uniform task mixture for pre/SFT training."""
    per = n // len(TASKS) + 1
    samples: List[Sample] = []
    for t in TASKS.values():
        samples.extend(t.make(rng, per))
    rng.shuffle(samples)  # type: ignore[arg-type]
    return samples[:n]
