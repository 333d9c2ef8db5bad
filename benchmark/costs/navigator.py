"""Model FLOPs of the GridMM navigator from its configuration file: the
products of every dense layer and of attention (2 operations a
multiply-add); layer norms, softmaxes, the geometry and the gathers are left
out. The pool counts one multiply-add a point and feature."""


def linear(rows: int, i: int, o: int) -> int:
    return 2 * rows * i * o


def attention(lq: int, lk: int, d: int) -> int:
    """Scores and the weighted sum: two (lq x d) . (d x lk) products."""
    return 4 * lq * lk * d


def self_layer(length: int, d: int, f: int) -> int:
    """q, k, v and the output projection, attention, the two FFN layers
    (a BERT layer and a pre-norm encoder layer alike)."""
    return (4 * linear(length, d, d) + attention(length, length, d)
            + linear(length, d, f) + linear(length, f, d))


def cross_layer(lv: int, lt: int, d: int, f: int) -> int:
    """Visual tokens cross-attend to lt context tokens, then a self layer."""
    return (2 * linear(lv, d, d) + 2 * linear(lt, d, d)
            + attention(lv, lt, d) + self_layer(lv, d, f))


def head(length: int, d: int, i: int = None) -> int:
    return linear(length, i or d, d) + linear(length, d, 1)


def _dims(conf):
    m, sh, g = conf["model"], conf["shapes"], conf["grid"]
    return (m["hidden_size"], m["intermediate_size"], m["image_feat_size"],
            m["angle_feat_size"], sh, g["num_views"] * g["patches_per_view"])


def language(conf: dict, rows: int) -> int:
    """The instruction encoder over `rows` padded instructions."""
    d, f, _, _, sh, _ = _dims(conf)
    return rows * conf["model"]["num_l_layers"] * self_layer(
        sh["max_txt_len"], d, f)


def panorama(conf: dict, rows: int) -> int:
    d, f, di, a, sh, _ = _dims(conf)
    v = sh["max_vp_len"] - 1
    return rows * (linear(v, di, d) + linear(v, a + 3, d)
                   + conf["model"]["num_pano_layers"] * self_layer(v, d, f))


def project(conf: dict, rows: int, points: int) -> int:
    """Text projection, the relevance products and the grid projection of
    `points` new points."""
    d, _, di, _, sh, _ = _dims(conf)
    t = sh["max_txt_len"]
    return rows * (linear(t, d, d) + 2 * points * t * d
                   + linear(points, di, d))


def navigation(conf: dict, rows: int, points: int, stray: bool) -> int:
    """The pool over `points`, the positional inputs, the map encoder, its
    cross-attention to the text, the local encoder and the heads."""
    d, f, _, a, sh, _ = _dims(conf)
    g, v, t, c = (sh["max_gmap_len"], sh["max_vp_len"], sh["max_txt_len"],
                  sh["num_cells"])
    lmap = c + g + (1 if stray else 0)
    per = (2 * points * d + linear(c, 5, d) + linear(g, a + 3, d)
           + linear(v, 2 * a + 6, d) + self_layer(lmap, d, f)
           + cross_layer(lmap, t, d, f)
           + conf["model"]["num_x_layers"] * cross_layer(g + v, lmap + t, d,
                                                         f)
           + 2 * head(g, d) + head(v, d) + head(1, d, 2 * d))
    return rows * per


def serve_step(conf: dict, rows: int) -> int:
    """One served step of `rows` slots (no stray keys), the pool over the
    whole buffer."""
    _, _, _, _, sh, pp = _dims(conf)
    return (panorama(conf, rows) + project(conf, rows, pp)
            + navigation(conf, rows, sh["max_points"], stray=False))


def train_forward(conf: dict, batch: int, steps: int) -> int:
    """The forward of one teacher-forced update over `batch` x `steps`: the
    language once, every panorama and every point once, then each step's
    navigation over the stacked buffer."""
    _, _, _, _, _, pp = _dims(conf)
    stray = bool(conf["model"]["compaction_stray_keys"])
    return (language(conf, batch) + panorama(conf, batch * steps)
            + project(conf, batch, steps * pp)
            + steps * navigation(conf, batch, steps * pp, stray))
