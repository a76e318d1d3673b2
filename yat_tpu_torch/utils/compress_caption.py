"""Caption compression to fit CLIP's 77-token budget.

A copy of ``yat_tpu/utils/compress_caption.py`` (stdlib only), so the
PyTorch package compresses captions identically without importing the JAX
package.  A spaCy POS/NER pass keeps adjective+noun pairs and PERSON/ORG
entities, drops stop keywords, deduplicates, and joins with commas; the
SD1.5 and SDXL frontends, whose CLIP encoders truncate at 77 tokens, run
it on every caption.

spaCy is not a hard dependency here: when importable (with the small English
model) the same POS/NER strategy runs; otherwise a deterministic rule-based
fallback extracts content phrases (stopword-filtered adjective/noun runs,
capitalized entity spans), dedups, and comma-joins.  Both paths are pure
functions of the caption.
"""

from __future__ import annotations

import re
from typing import List

# drop-keywords: words that describe the picture, not its content
_STOP_KEYWORDS = frozenset({
    "image", "images", "picture", "pictures", "photo", "photos",
    "photograph", "view", "background", "foreground", "scene", "shot",
    "close-up", "closeup", "overall", "setting",
})

_STOPWORDS = frozenset("""
a an the and or but of in on at to for with from by as is are was were be
been being this that these those it its it's there here which who whom
whose what when where why how all any both each few more most other some
such no nor not only own same so than too very can will just should now
has have had do does did
""".split())

_WORD_RE = re.compile(r"[A-Za-z0-9'-]+")


def _try_spacy():
    try:
        import spacy
        try:
            return spacy.load("en_core_web_sm")
        except OSError:
            return None
    except ImportError:
        return None


_NLP = None
_NLP_CHECKED = False


def _get_nlp():
    global _NLP, _NLP_CHECKED
    if not _NLP_CHECKED:
        _NLP = _try_spacy()
        _NLP_CHECKED = True
        if _NLP is None:
            # the rule-based fallback is deliberate (offline-safe,
            # deterministic) but must not be a silent substitution for the
            # POS/NER compressor
            import logging
            logging.getLogger(__name__).warning(
                "spaCy en_core_web_sm unavailable — caption compression "
                "falls back to the deterministic rule-based compressor "
                "(install spacy + en_core_web_sm for POS/NER compression)")
    return _NLP


def remove_word(caption: str, word: str) -> str:
    """``caption`` with every whole-word ``word`` removed."""
    return re.sub(rf"\b{re.escape(word)}\b", "", caption).strip()


def _spacy_compress(caption: str, nlp) -> List[str]:
    doc = nlp(caption)
    phrases: List[str] = []
    # adjective+noun pairs from noun chunks
    for chunk in doc.noun_chunks:
        words = [t.text.lower() for t in chunk
                 if t.pos_ in ("ADJ", "NOUN", "PROPN")
                 and t.text.lower() not in _STOP_KEYWORDS]
        if words:
            phrases.append(" ".join(words))
    # named entities of interest
    for ent in doc.ents:
        if ent.label_ in ("PERSON", "ORG"):
            phrases.append(ent.text)
    return phrases


def _fallback_compress(caption: str) -> List[str]:
    """Rule-based phrase extraction: contiguous runs of content words."""
    phrases: List[str] = []
    for clause in re.split(r"[.;,!?]| - ", caption):
        run: List[str] = []
        for raw in _WORD_RE.findall(clause):
            w = raw.lower()
            if w in _STOPWORDS or w in _STOP_KEYWORDS:
                if len(run) >= 1:
                    phrases.append(" ".join(run))
                run = []
            else:
                run.append(w)
        if run:
            phrases.append(" ".join(run))
    return phrases


def compress_caption(caption: str, max_words: int = 60,
                     class_label: str = None, id_label: str = None) -> str:
    """Compress a long caption into comma-joined content phrases (at most
    ``max_words`` words).  With both ``class_label`` and ``id_label``
    given, every occurrence of the class word is prefixed with the
    Dreambooth identifier — '<class>' → '<id> <class>'."""
    if not caption:
        return caption
    nlp = _get_nlp()
    phrases = _spacy_compress(caption, nlp) if nlp is not None \
        else _fallback_compress(caption)

    seen = set()
    out: List[str] = []
    n_words = 0
    for p in phrases:
        key = p.lower()
        if not p or key in seen:
            continue
        seen.add(key)
        w = len(p.split())
        if n_words + w > max_words:
            break
        out.append(p)
        n_words += w
    if class_label is not None and id_label is not None:
        # word-boundary match: a plain substring replace corrupts words
        # that merely contain the class label ("cat" in "scattered")
        pat = re.compile(r"\b" + re.escape(class_label) + r"\b")
        out = [pat.sub(f"{id_label} {class_label}", p) for p in out]
    return ", ".join(out) if out else caption
