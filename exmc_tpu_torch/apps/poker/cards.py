"""Card utilities (``exmc_tpu/apps/poker/cards.py``, in numpy): a card
is rank * 4 + suit; 5- and 7-card hand evaluation and Monte-Carlo hand
strength, which consumes ``numpy.random.default_rng(seed)`` as the JAX
package's copy does, so its results are equal bit for bit."""

import itertools

import numpy as np

RANKS = "23456789TJQKA"
SUITS = "cdhs"


def parse(s):
    """"Ah" -> card int."""
    r, su = s[0], s[1]
    return RANKS.index(r) * 4 + SUITS.index(su)


def card_name(card):
    return RANKS[card // 4] + SUITS[card % 4]


def rank(card):
    return card // 4


def suit(card):
    return card % 4


def deck():
    return list(range(52))


def evaluate_5(five):
    """Rank a 5-card hand; a larger tuple is a better hand."""
    rs = sorted((rank(c) for c in five), reverse=True)
    ss = [suit(c) for c in five]
    counts = {}
    for r in rs:
        counts[r] = counts.get(r, 0) + 1
    by_count = sorted(counts.items(), key=lambda kv: (-kv[1], -kv[0]))
    flush = len(set(ss)) == 1
    uniq = sorted(set(rs), reverse=True)
    straight_high = None
    if len(uniq) == 5:
        if uniq[0] - uniq[4] == 4:
            straight_high = uniq[0]
        elif uniq == [12, 3, 2, 1, 0]:  # the wheel, A2345
            straight_high = 3
    kick = tuple(r for r, _ in by_count)
    if straight_high is not None and flush:
        return (8, straight_high)
    if by_count[0][1] == 4:
        return (7,) + kick
    if by_count[0][1] == 3 and by_count[1][1] == 2:
        return (6,) + kick
    if flush:
        return (5,) + tuple(rs)
    if straight_high is not None:
        return (4, straight_high)
    if by_count[0][1] == 3:
        return (3,) + kick
    if by_count[0][1] == 2 and by_count[1][1] == 2:
        return (2,) + kick
    if by_count[0][1] == 2:
        return (1,) + kick
    return (0,) + tuple(rs)


def evaluate_7(seven):
    """The best 5 of 7 cards."""
    return max(evaluate_5(c) for c in itertools.combinations(seven, 5))


def hand_strength(hole, board, samples=500, seed=0):
    """Monte-Carlo equity against one random opponent."""
    rng = np.random.default_rng(seed)
    known = set(hole) | set(board)
    remaining = [c for c in deck() if c not in known]
    need_board = 5 - len(board)
    wins = 0.0
    for _ in range(samples):
        draw = rng.choice(len(remaining), size=need_board + 2, replace=False)
        cards_drawn = [remaining[i] for i in draw]
        opp = cards_drawn[:2]
        full_board = list(board) + cards_drawn[2:]
        mine = evaluate_7(list(hole) + full_board)
        theirs = evaluate_7(opp + full_board)
        wins += 1.0 if mine > theirs else (0.5 if mine == theirs else 0.0)
    return wins / samples
