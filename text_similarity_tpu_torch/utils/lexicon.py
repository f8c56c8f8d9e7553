"""Offline taxonomy lexicon and hypernym topic names (a copy of
``text_similarity_tpu.utils.lexicon``, which imports no JAX: the port keeps
its own).

A topic's name is the set of most specific common ancestors ("lowest
common hypernyms") of the noun senses of its top c-TF-IDF words.
``Lexicon`` holds the lemma → synsets and synset → hypernyms maps, loaded
from JSON or, where nltk and its WordNet data are installed, built by
``Lexicon.from_wordnet()`` (which raises without them);
``lowest_common_hypernyms`` and ``name_topics`` do the naming; and
``demo_lexicon()`` is a miniature taxonomy for offline tests.
"""

from __future__ import annotations

import itertools
import json
from typing import Dict, List, Optional, Sequence, Tuple


class Lexicon:
    """A lemma → synset → hypernym taxonomy.

    ``synsets_by_lemma``: lowercase lemma → synset ids.
    ``hypernym_map``: synset id → direct hypernym synset ids (DAG edges
    toward the root(s)).
    ``names``: synset id → display name (defaults to the id itself).
    """

    def __init__(
        self,
        synsets_by_lemma: Dict[str, List[str]],
        hypernym_map: Dict[str, List[str]],
        names: Optional[Dict[str, str]] = None,
    ):
        self.synsets_by_lemma = {
            k.lower(): list(v) for k, v in synsets_by_lemma.items()
        }
        self.hypernym_map = {k: list(v) for k, v in hypernym_map.items()}
        self.names = dict(names or {})
        self._depth_cache: Dict[str, int] = {}
        self._anc_cache: Dict[str, Dict[str, int]] = {}

    # -- core graph ops ---------------------------------------------------

    def synsets(self, lemma: str) -> List[str]:
        return self.synsets_by_lemma.get(lemma.lower(), [])

    def name(self, synset: str) -> str:
        return self.names.get(synset, synset)

    def ancestors(self, synset: str) -> Dict[str, int]:
        """All hypernym ancestors of ``synset`` (inclusive) with the
        shortest hop-distance to each. Memoized: the LCH all-pairs loop
        and the coverage scorer both hit the same synsets repeatedly
        (a real-WordNet topic does thousands of lookups per naming call)."""
        cached = self._anc_cache.get(synset)
        if cached is not None:
            return cached
        dist = {synset: 0}
        frontier = [synset]
        while frontier:
            nxt = []
            for s in frontier:
                for h in self.hypernym_map.get(s, []):
                    d = dist[s] + 1
                    if h not in dist or d < dist[h]:
                        dist[h] = d
                        nxt.append(h)
            frontier = nxt
        self._anc_cache[synset] = dist
        return dist

    def depth(self, synset: str) -> int:
        """Longest hypernym path from ``synset`` up to a root — the
        WordNet ``max_depth`` notion (deeper = more specific)."""
        if synset in self._depth_cache:
            return self._depth_cache[synset]
        # iterative longest-path on the hypernym DAG (memoized)
        seen: Dict[str, int] = self._depth_cache
        stack = [(synset, False)]
        while stack:
            s, expanded = stack.pop()
            if s in seen:
                continue
            parents = self.hypernym_map.get(s, [])
            if expanded or not parents:
                seen[s] = (
                    1 + max(seen[p] for p in parents) if parents else 0
                )
            else:
                stack.append((s, True))
                stack.extend((p, False) for p in parents if p not in seen)
        return seen[synset]

    def lowest_common_hypernyms(self, s1: str, s2: str) -> List[str]:
        """Deepest common ancestors of two synsets (WordNet
        ``Synset.lowest_common_hypernyms`` semantics: the common ancestors
        of maximal taxonomy depth)."""
        common = set(self.ancestors(s1)) & set(self.ancestors(s2))
        if not common:
            return []
        best = max(self.depth(c) for c in common)
        return sorted(c for c in common if self.depth(c) == best)

    # -- persistence ------------------------------------------------------

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "synsets_by_lemma": self.synsets_by_lemma,
                    "hypernym_map": self.hypernym_map,
                    "names": self.names,
                },
                f,
            )

    @classmethod
    def from_json(cls, path: str) -> "Lexicon":
        with open(path) as f:
            d = json.load(f)
        return cls(
            d["synsets_by_lemma"], d["hypernym_map"], d.get("names")
        )

    @classmethod
    def from_wordnet(cls, pos: str = "n", lang: str = "eng") -> "Lexicon":
        """Build from nltk WordNet when its corpus data is installed
        (raises LookupError offline — callers fall back to JSON/demo)."""
        from nltk.corpus import wordnet as wn

        synsets_by_lemma: Dict[str, List[str]] = {}
        hypernym_map: Dict[str, List[str]] = {}
        for syn in wn.all_synsets(pos=pos):
            sid = syn.name()
            hypernym_map[sid] = [h.name() for h in syn.hypernyms()]
            for lemma in syn.lemma_names(lang=lang):
                synsets_by_lemma.setdefault(
                    lemma.lower().replace("_", " "), []
                ).append(sid)
        names = {s: s.split(".")[0].replace("_", " ") for s in hypernym_map}
        return cls(synsets_by_lemma, hypernym_map, names)


def common_hypernyms_for_words(
    words: Sequence[str], lexicon: Lexicon
) -> List[Tuple[str, int, int]]:
    """Rank candidate category synsets for a word set.

    All-pairs lowest common hypernyms over the words' synsets (the
    reference iterates ``combinations(synsets, 2)``,
    topic_modeling.py:176-182), scored by (#words covered, depth): a good
    topic name subsumes many of the top words and is as specific as
    possible. Returns ``[(synset, coverage, depth), ...]`` best-first.
    """
    syns_per_word = [
        (w, lexicon.synsets(w)) for w in words if lexicon.synsets(w)
    ]
    all_syns = [s for _, ss in syns_per_word for s in ss]
    candidates: set = set()
    for s1, s2 in itertools.combinations(all_syns, 2):
        candidates.update(lexicon.lowest_common_hypernyms(s1, s2))
    scored = []
    for c in candidates:
        cover = sum(
            1
            for _, ss in syns_per_word
            if any(c in lexicon.ancestors(s) for s in ss)
        )
        scored.append((c, cover, lexicon.depth(c)))
    scored.sort(key=lambda t: (-t[1], -t[2], t[0]))
    return scored


def name_topics(
    topics: Dict[int, List[Tuple[str, float]]],
    lexicon: Lexicon,
    max_words: int = 6,
    n_names: int = 3,
) -> Dict[int, List[str]]:
    """Name each topic by the best-ranked common hypernyms of its top
    c-TF-IDF words (reference ``find_general_categories``,
    topic_modeling.py:171-182). Topics whose words are absent from the
    lexicon get an empty name list."""
    out: Dict[int, List[str]] = {}
    for t, word_scores in topics.items():
        words = [w for w, _ in word_scores[:max_words]]
        ranked = common_hypernyms_for_words(words, lexicon)
        out[t] = [lexicon.name(s) for s, _, _ in ranked[:n_names]]
    return out


def demo_lexicon() -> Lexicon:
    """A miniature English noun taxonomy (animals / vehicles / food) for
    offline tests and examples."""
    h = {
        "entity.n.01": [],
        "animal.n.01": ["entity.n.01"],
        "mammal.n.01": ["animal.n.01"],
        "bird.n.01": ["animal.n.01"],
        "dog.n.01": ["mammal.n.01"],
        "cat.n.01": ["mammal.n.01"],
        "horse.n.01": ["mammal.n.01"],
        "sparrow.n.01": ["bird.n.01"],
        "eagle.n.01": ["bird.n.01"],
        "vehicle.n.01": ["entity.n.01"],
        "car.n.01": ["vehicle.n.01"],
        "truck.n.01": ["vehicle.n.01"],
        "bicycle.n.01": ["vehicle.n.01"],
        "food.n.01": ["entity.n.01"],
        "fruit.n.01": ["food.n.01"],
        "apple.n.01": ["fruit.n.01"],
        "banana.n.01": ["fruit.n.01"],
        "bread.n.01": ["food.n.01"],
    }
    lemmas = {
        "dog": ["dog.n.01"],
        "puppy": ["dog.n.01"],
        "cat": ["cat.n.01"],
        "kitten": ["cat.n.01"],
        "horse": ["horse.n.01"],
        "sparrow": ["sparrow.n.01"],
        "eagle": ["eagle.n.01"],
        "car": ["car.n.01"],
        "truck": ["truck.n.01"],
        "bicycle": ["bicycle.n.01"],
        "bike": ["bicycle.n.01"],
        "apple": ["apple.n.01"],
        "banana": ["banana.n.01"],
        "bread": ["bread.n.01"],
    }
    names = {s: s.split(".")[0] for s in h}
    return Lexicon(lemmas, h, names)
