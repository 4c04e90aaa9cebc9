"""TPC-H's fixed vocabulary, as the benchmark's generator uses it.

The dictionaries (regions, nations, segments, priorities, ship modes and
instructions, part types, containers, brands, colours), the nation-to-region
map, the "current date" of the status flags, and the comment dictionaries
with the specification's 'special requests' and 'Customer Complaints'
populations.  The columns themselves are drawn on the card by
``device_tpch.py``; the tests hold its schema, dictionaries and domains to
the program's generator (``repro_torch.data.tpch``).
"""
from __future__ import annotations

import numpy as np


__all__ = ["days", "NATIONS", "REGIONS", "NATION_REGION"]

_EPOCH = np.datetime64("1970-01-01")


def days(date_str: str) -> int:
    """Date literal -> epoch days."""
    return int((np.datetime64(date_str) - _EPOCH)
               .astype("timedelta64[D]").astype(np.int64))

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"])
NATIONS = np.array([
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA", "FRANCE",
    "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA",
    "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
    "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES"])
NATION_REGION = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0,
                          0, 0, 1, 2, 3, 4, 2, 3, 3, 1])

SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"])
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"])
SHIPMODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB",
                      "AIR REG"])  # Q19's second mode parameter
INSTRUCTS = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"])
ORDERSTATUS = np.array(["F", "O", "P"])
RETURNFLAGS = np.array(["A", "N", "R"])
LINESTATUS = np.array(["F", "O"])

_TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
TYPES = np.array([f"{a} {b} {c}" for a in _TYPE_S1 for b in _TYPE_S2 for c in _TYPE_S3])

_CONT_S1 = ["SM", "LG", "MED", "JUMBO"]
_CONT_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM", "BARREL", "BOTTLE"]
CONTAINERS = np.array([f"{a} {b}" for a in _CONT_S1 for b in _CONT_S2])

BRANDS = np.array([f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)])
MFGRS = np.array([f"Manufacturer#{i}" for i in range(1, 6)])

COLORS = np.array("""almond antique aquamarine azure beige bisque black blanched blue
blush brown burlywood burnished chartreuse chiffon chocolate coral cornflower cornsilk
cream cyan dark deep dim dodger drab firebrick floral forest frosted gainsboro ghost
goldenrod green grey honeydew hot indian ivory khaki lace lavender lawn lemon light
lime linen magenta maroon medium metallic midnight mint misty moccasin navajo navy
olive orange orchid pale papaya peach peru pink plum powder puff purple red rose rosy
royal saddle salmon sandy seashell sienna sky slate smoke snow spring steel tan thistle
tomato turquoise violet wheat white yellow""".split())

_CURRENT = "1995-06-17"
N_COMMENT_TEMPLATES = 512


def _comment_dict(rng: np.random.Generator, n: int, specials: list[str],
                  special_frac: float) -> np.ndarray:
    """Small template dictionary with a controlled special-pattern population."""
    words = np.array("""carefully final deposits sleep furiously quick requests
boost blithely ironic packages cajole express accounts haggle silent pinto beans
wake regular theodolites nag slyly bold foxes integrate daring sauternes""".split())
    base = [" ".join(rng.choice(words, size=8)) for _ in range(n)]
    n_special = max(1, int(n * special_frac))
    for i in range(n_special):
        mid = " ".join(rng.choice(words, size=2))
        base[i] = f"{base[i][:20]} {specials[0]}{mid}{specials[1]} {base[i][20:40]}"
    return np.array(base)
