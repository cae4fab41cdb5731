"""The dashboard's caption glyphs: a stand-in for ``cv2.putText(canvas, text,
org, cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 1)`` of
``bundlesdf_tpu/viz/gui.py:45-46``, for the characters a caption holds
(``CHARS``).

``TABLE`` holds, for each character, the coverage (0..255) that OpenCV
draws for it alone at that font and scale with its origin on a whole
pixel, the pixel offset of that bitmap from the origin, and the pen
advance in whole pixels.  ``tests/test_torch_viz.py`` renders the table
again with cv2 and checks that it equals this one.  OpenCV draws the text
antialiased and blends each glyph over what is below it in turn, ``bg +
((color - bg) * a + 127) // 255``; ``draw_text`` does the same, with the
pens placed at the sum of the whole-pixel advances.
"""
from __future__ import annotations

import base64
import functools
import zlib

import numpy as np

CHARS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_=. -"

# zlib + base64 of, per character of CHARS: advance, dy, dx (int8), h, w
# (uint8), then h * w coverage bytes (see encode_table).
TABLE = (
    "eNqtWQdcVFfWP2+GQdqAgA0rgim2oNHEaKIYjLElmqJGTDFq7DHEgmLBEBsW1KhhI6to1NjFiAoT"
    "BbtrsIAQQQlFBByFSJE2M0x55zv33jdo4vdzs/vbg879z3u3nn7uuNSAuwsQObYATj2u1GNVtBNA"
    "V5P14NeIxwEO4WCQsquxF5Q+coA3syZgmBseAzg8wxdjm+NuaF2hbYx7GVr6PRByw3jHB52gHW6H"
    "kopPzgCMx8VwGHEkSD9jIPRA3Dv9N6Tn0LfMhlXb3fjKLm0l9lkruTkDOG8zzWYP/W8gRlDbr7Ii"
    "jINXktp34YDovwDdwsM345nw8D50NE4rXGokrTNjQDPezf90Pd5dpwavktpvp5zBLRCOowGk3DrN"
    "d9cd6f0P6M/7aX6rcWCtFI2LWKvegfvZA/VPeEBpDyvtUQ3rsAVrl4UTdc5TVp7iUgtaF1hh5lTt"
    "BIFLiI5gioov8FxpTlMOWt4p8ePA87fqHuIsm7D6ZATn2htfh58ypXuKx7ASg6Vu/EtPjHI1n2cM"
    "XUf7/wETPh23z5jvAZqwEsTy/V68u1drzvdacHPl34eU1yoztSi1olAIKfFBrAK/lIeuErCzIRoE"
    "bJR+20WB68y0Ow772RLfe++9OJz6HixQDouyxqUDo23Yu62y2yhlXqKlFi8uepLEHc6O6+CE5xk/"
    "xoMvzhademOwAO/jsui4tS8DTEfb2YRyWxj0WtULoPFF28uiwzCcO/1NBvrgoswKdqaN2HuSnDnh"
    "o914zgE+zrRhyZZGrIO2rcICLbcC2FvXUkwxDZcK0NnwKxc0OGVU+9vZb6nPWE5K87ps2hmegNcc"
    "4bjcn14swlmSMZ118bAck8pS+NzGoxBneZHQOAyB7uUPF360znK9ManiyWq8/5OQhFqRBOn+eqEP"
    "xo6DVzLKw/ZC+LVnxeJz8X0x5E6BmoMRGCreJNeJyTrLMeLBFrmLMva0fewIAVJv8bEuf7X+Aelm"
    "LNulJWDNmjhslfkaQIzZm14sxBfgwCNmAJPwNQjG2Hauw4qLSbF/5MLtCfCZOefbadssv7WQ7mW6"
    "cSHNa49r2aQOpmOOxstqLo5vSEdPB785t7LsBVDP1iNWnVTOJ6y/RhGEs7BGCLphwZJltO5QuSh8"
    "6kk8DHCrog2Aaj/29ZAPsy5DMdTJ8gtDo/ErOGvsA+B2Ue4Encrqft5aQE4JwGdjSiEWC+7AQVuQ"
    "ABNwtQDP13DTJjpW8QJrXMkkuHlNqb+psuvozXp8W4Gv4sKa/Qr+weS93Simdq48BH1xBscf41CQ"
    "clKFYPRqxsEAgr623V27dh2CGwlHKKbx0BFUBVmDGK0kHzlA0XdtbSJsrmmuiLLezZW0wyWM6Ubt"
    "ldWNIBKXTJ268DweJfQ863JZbqqgGHyJI01Q1V1NJJbo9TVYE0D91i1YsOIm/mgfsQ+7KuhDnKGg"
    "rdgvEhdOmBCSbL3oGM62Z83Y7AauNZLQlCbCVXjuyEO54GsHcL8iXw6JuIz7yVEuZGp5A99Oktux"
    "Pq/LS6quie1rVJZkOx8fo+qrdnTG1oY1veoXfcu1WXUVh3mlW5MnzzuNxyVotrcIsWSxE+/r4ylE"
    "pHDDlPXTeKATbVyy9JwVVyhna3IJX1dONAXnKKgZ7lUQWE48hdxwn4Jew3kCqfdjUCSunhsanYrb"
    "VYwbcuHx+SphqGHCUOuHEF+Zp1riG4ltxHH+P3DlAtHPBI4dINoCz+y8fC6jzuGKhoQ8uaDplUj8"
    "B3MNK1pEop99xNNgYwTRNAJWC1EuPLOzAsKtrQRokLe3CM5uMTmyXDDPEdwvyZdmzTmPiar5FNRJ"
    "Ursx+KSNy7tpeN/Ka3aJGs/Tx9e0g3c5upKfj/GPxFsNHkpW5I3zwzGMzbId+3inWZKmTk/ETRJ4"
    "kbwtaQuUWMQ1zo3L2yA4pG+QoyHx36Gcm4xshM4nMrIm/t2x4VZ+LCg77ECLqxcYO0RiwDP+hdue"
    "F4HksBCUeQqMWspoJ85TuBL4H6OBOLt3+jCGVuDb7TGJvKTDTZsHHMGEz8MKcQmJam01ylmiv6qV"
    "V0MgCTP4EAyrm8+luxK3qwlIGzFGRfLusBW/l5jgz+J6iWsApTpCFeQiPwFCTIXthXIMNd5tL7Tk"
    "bcNdX6EuA+oK2gl16V+e5cwWXGD0tatTp/812MRSp0VNFYOQX9PSgm7zDQPE+321npF4TeKuWUYf"
    "OswH3O8iw1lZ5H2DMIvhUTgOpJTrkQz76AocR+DQlRy/In91818gMBytxyA7fsmaDHYMzZ0fY5Fv"
    "+Sy2eAu82OwldLS2H/va3TSKdI8lln1xIm1ojR2ds/RUUMDDdI1APsFkSwJBvKmTglpWXA4UiBLo"
    "QwqSfkEFQdtqnBgulp8sj3nsoUUs024vQOPlseSqU+RdkxZl2qZT+J9DLxpnmF2PmdnOYDYO+EOE"
    "qDdwsfEMR51wbQOKKsvgqD8u0Qmz2IxDFvNEWlNqa+xzWz4/Ze19/JY4E/8HWjOVRK2V6588tPmP"
    "k9OZDKNCQzcX4RZFrNIVWxNFwCE4QkE/sYjUr3nznhHGAilSCPt6GxoxZ+TIgT5cEwLArhNPI7JA"
    "aPBfHk9zI/gxN6Y0cMPk3MCNoL/JjYgGbgTbuWH1t3Njo8KNbHmvnRtrcbiyL6lVo8d8yY7qr6bd"
    "rwkN3VqMq5TI5XDf6qL4oO8b4vPNKsdI/Dgw8It43AmCL6YwB0Ijunc/ZuoAYqyfKV5B9DlIQdr7"
    "tzSKJ/vEMqYh42vkw80FRmeYsTqWsoyJcto3Uw9YbrnD5TqWDS7FKZBTxDpp3vGlkx5WWOsYY8HU"
    "2SJLbjHnmmz9XsmdOhzB1Z5juWVoKlJbWY+ysZ1tB2EXJs8YsyHX8g5IYdlWNF57XWRLvmql+nBZ"
    "pjhM89TBGzZsqHlAH6+xLvdS7OHkf41yzihBReuyqbqR0JionciDnSdu/c/RD8hZ0g43TcYvRAEx"
    "vjvqiAdSMnZW78GcxYtzcZcK1BvuyPKd9SJ39/K2p5uuwcaB/FHrqhU+1t2gmCecrua6ee2BGr7A"
    "UYzNuInG1ccxl4O9Wc5qdAfILGDcDsbPoCtpEp8zkSJGN+EezU3zb4lzD8ftLGZwQVYg2s3lOzwn"
    "Uk5w0wbUf2rn0qEcrW2HXXMrTsFtZgBBVMv40SI/WZzAT6Yno2hfs/BV+k+1CosN/XAqnD1n/ApO"
    "VUjgbvunl2V8fDKUsbwv+/qnZq/PzAE89d5jij8FnuaDrMKmw5JNwkkbr6/7o5VUcjJWslO5Vyey"
    "5K36qFKrBpnXiESe9DReZjn5RFxGHUr03uBXncqq7XcxTn3RIKJHDJ7Gr8UZ3PLwjJLPtyrHmyKf"
    "VCVbdzOe8j0sU52ShxAKMKU4gM/DkmbgdJOXfcPl49Ic2ydK/TeUi+wz4zARrQ3TnfLvMDlpMu9r"
    "4T3uEmYj63zS6A8tqy+xY3Q0H4c91u58xDpcK4t4Cx4lWK6EEJiJ8+2sH4mfPhsOxQ/t1buLr1Gx"
    "n9HaCJ5xlJP5c5qM+5TrD0OBhzC7TEsfUBgTLsAoPC/U0beyQiRYml/F7MyR/FOAAJs1kgXh8Dfe"
    "ttf0a5wN4MrVU3BSvaBQrjhMMyzBqLdCH6aqYNzn9Hg1sqLKZcC0BAyETrFVZecuYqB0/XpfNfng"
    "wEAeqxMxsJnlXM/u0TbqM4iy/ZS58itMTCKfodjm7K0EXThxVwG64ieAowAj0qzFK9Wgs1RFTU6g"
    "+lPHlEt1weChq2Vl/FfYR1co7hDe19WyU0/FfjoczOzI0kRnuz9zUDTugLjrs8qwfg+PY1Ib5h8a"
    "jqoRCjT6gqHuQi+Aj6y/zZpfZAyAq3XkCl41R2sthzgrm/gzpeTewbaTe1wHuFFJUz1Xu4UWTfhg"
    "9A35LdpQAeJdca/RvIUkSnJn5VjeLe3nK1LAST23XAGm5NiyZ57SU3KQMjNCb9ZDXiF5ggCrvjFu"
    "Zd1u6F+gepsN1zfBaF7260F/i0b7W/QQikfeHZ9l04M6shZr1u/NYQJsp/7TUZXblNOGoh8pJAyq"
    "Pzx0QsE1V7iUTqzsgVO15i1NiSq2dVQU4oK2NsaHkRa2Z1Afx5HPw+u4q0efJBsZ1eCD9ZjzgWAJ"
    "E6sjFfuMtYPXHKC3Y+SHCSMAEsq5N77F/PNmvcWk1/cfEvZHblgYqdXtU3zw32hSjzKtMSisVALU"
    "tFzb7ZCof8HnxK9v7hlKIZvxq7u11E0W/Cr1Ffw6XqoVVyhppZCTT+HyJWsplZFnJ86/aymlqiZf"
    "zp+fWAov+7KZ01IgJ5fm6VAfDSMtd2L3Pcwl19Vt3fHdM1sDv1z0bmVX3FK7PMueABoBBqaZ70Qx"
    "xa3eGZKG60hxyR1CXo1Kxy9g1mFHMSoEez8DxHHlniQHONDKqu69821jJgHE/pKU++RffLpDDXrS"
    "ws8HkZTi8SWqM0LclD3Nu0MS2MAC29/4iKl3cO5VnEapSsUr0KYz2YYTLezkrdwnnbitnDP36dYn"
    "Kc+b2peLS/rQ9w9rMyhH0dXL8WwfOuRlIejuHuThSper/hFX8nGqaKpY4tLJLlfZvuSn9PY5kacr"
    "ePovLtPDILm4N2gyv8aLPRJaXH/pufa62ntLAZLkvGnfmO4U7hl/HEMhCSm0zcEk6nr7KiQ9ZNfN"
    "3Jf/aFInsZ37Ywiwgzv9/W/x7DqwtXUSK+CMGhfa0GPTik14N82St1KCJGP19lkZlEcnUQAHqaiE"
    "nrjzQNM6qVhc3HV5Boj/nYHpNv8Gy3UQyd3w5NqHP5NwR5gzvowo+qMjpDAn1QM3u5r59VXOzXYs"
    "eSffV+YhAn1GjnBSL2IsfCHrhk+4YaBoMeN32ZIq0pOmbtyypCcsKybhw3Tr/SgN6EyP1pPT3Uzi"
    "G8ucbr2nzujIne4bj51ulYo73f46ZNdwx2zNdLYHX5LT3U3Oe/JDrN/rxty5cLoNDj7RDp6zp/p/"
    "Ne6Z+bac2VEXYRJenRlxz0DO8B7Fu25Wvbu8QzhDf1zOj6r3Qm7cl8gZ5tAqrY16mI9Hh4/LYM5w"
    "VS1Wr/mFuVl1WzUk6JXlGsCJewro0M3RKDk7xp4Yeba4d5LRnPQPvyR8l14kPWKKJoTz9Gd8No+X"
    "JCgeM8Ul9M4HtrwQCU5UTQtcKYeojHtYsdgFLhqW92CCbLajCgtXs9M6DYixxrkMZPBCpa/hQm+/"
    "cdZj0P+GjIY45lK1LKdW/GprEe9rxGWwYdvjZrNertMXtRgSZr4aFur853d/be6K6mdv/XcTyA15"
    "H6vEIBcjKXH8EfY4IleVkSauDTXPAJd5/DqBmhjsQiWXCTWDbOlTPr9iRQ3MuIfGnd8ZWOBpza3C"
    "2QjOzmML2Y057Djf1hrFfgOxrCOvTK8XyC9Scvc+SLnnSULFxylT/Jjtw9JyVxljaBvrKsN6cZVr"
    "w47iBsXM0kctzeo+sIgyEYdUlj5OL2jUwkbZ1ptYTuK6fA3g14sAG+/jW9DESnnRAqu3VPjtjWj4"
    "lFWXnfGTnhgQrlftL2BT5u1bnkcFYd9Kdo0L6yuzacbbv+IAcXWDVLssx0rhc4p+Jwl2qd9qP9jL"
    "+pnMrRRMhH2WvuB1N9MVtNn6Fidq2HlfMjzAMXzTsXiFt30t93ACyw30OZ6nDN1BnVzXFZoU5Tce"
    "Z2Xn7lX3Hc2qdQ4u7MoLxtRWZiZuH3M0HKgl+UcQu/riV+D4QMdsIFsai0N4vvzW5WymWc5lN/FL"
    "vtBqfKRVfmVZr/w8YxM/d7hWxIsHk1C5bmnZW/wgws7jU6RntA1cQsPCwi4ogwPqUrlxeuWX8+t9"
    "lY4lAETLRISldDqB51HtHplnjB07dqQ0SGQQZnc3lFSu+3V2+uYJ6GySHJ3iH3GaNXgapy7wF1pw"
    "gNM7EUc5ve9gk9RqlQOk2/zSrX48BjiZJVWj/VlEGR6zo4k2Ov0fXy5FEQ=="
)


def encode_table(glyphs: dict) -> str:
    """``{char: (advance, dy, dx, coverage (h, w) uint8)}`` -> TABLE text."""
    out = bytearray()
    for ch in CHARS:
        adv, dy, dx, cov = glyphs[ch]
        cov = np.asarray(cov, np.uint8)
        out += np.array([adv, dy, dx], np.int8).tobytes()
        out += np.array(cov.shape, np.uint8).tobytes() + cov.tobytes()
    return base64.b64encode(zlib.compress(bytes(out), 9)).decode()


@functools.lru_cache(maxsize=1)
def decode_table(text: str = None) -> dict:
    """TABLE text -> ``{char: (advance, dy, dx, coverage (h, w) uint8)}``."""
    raw = zlib.decompress(base64.b64decode(TABLE if text is None else text))
    glyphs, i = {}, 0
    for ch in CHARS:
        adv, dy, dx = np.frombuffer(raw[i:i + 3], np.int8).tolist()
        h, w = raw[i + 3], raw[i + 4]
        cov = np.frombuffer(raw[i + 5:i + 5 + h * w], np.uint8).reshape(h, w)
        glyphs[ch] = (adv, dy, dx, cov)
        i += 5 + h * w
    return glyphs


def draw_text(img: np.ndarray, text: str, org, color=(255, 255, 255)) -> np.ndarray:
    """Blend ``text`` into the (H, W, C) uint8 image in place, its first
    pen at ``org`` (x, y of the baseline's left end); returns the image.
    Characters outside CHARS raise KeyError."""
    glyphs = decode_table()
    H, W = img.shape[:2]
    col = np.asarray(color, np.int64)[:img.shape[2]]
    x, y = int(org[0]), int(org[1])
    for ch in text:
        adv, dy, dx, cov = glyphs[ch]
        ys, xs = np.nonzero(cov)
        a = cov[ys, xs].astype(np.int64)[:, None]
        ys, xs = ys + y + dy, xs + x + dx
        keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        ys, xs, a = ys[keep], xs[keep], a[keep]
        bg = img[ys, xs].astype(np.int64)
        img[ys, xs] = (bg + ((col - bg) * a + 127) // 255).astype(img.dtype)
        x += adv
    return img
