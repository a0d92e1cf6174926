"""The port's selection language (``Universe.select_atoms``,
``AtomGroup.select_atoms``) against the JAX package's: on the same
float32 frames and topology, every expression returns the JAX ``ix``,
with at least one expression per keyword of the grammar, the geometric
ones (``around``, ``point``, ``sphzone``, ``prop``) in a periodic
orthorhombic box, in a triclinic box and without a box; invalid
selections raise the same errors.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from mdhelper_tpu.core.universe import Universe as JaxUniverse  # noqa: E402

from mdhelper_tpu_torch.core.universe import AtomGroup, Universe  # noqa: E402

N_ATOMS, BOX = 240, 18.0
BOXES = {
    "periodic": np.array([BOX, BOX + 1.0, BOX + 2.0, 90.0, 90.0, 90.0]),
    "triclinic": np.array([BOX, BOX, BOX, 80.0, 75.0, 90.0]),
    "open": None,
}


def _system(box="periodic"):
    """The port's universe and the JAX package's over the same two
    float32 frames and topology: 80 three-atom molecules (O, H1, H2) of
    two residue names in two segments."""

    rng = np.random.default_rng(31)
    traj = (rng.random((2, N_ATOMS, 3)) * BOX).astype(np.float32)
    # a few atoms just outside the box and on its faces
    traj[0, :4] = [[-0.25, 3.0, 4.0], [BOX + 0.5, 1.0, 2.0],
                   [0.0, 0.0, 0.0], [BOX, BOX, 0.5]]
    mol = np.arange(N_ATOMS) // 3
    attrs = dict(
        names=np.array(["O", "H1", "H2"] * (N_ATOMS // 3), dtype=object),
        types=np.array(["OW", "HW", "HW"] * (N_ATOMS // 3), dtype=object),
        masses=np.tile([15.999, 1.008, 1.008], N_ATOMS // 3),
        charges=np.tile([-0.834, 0.417, 0.417], N_ATOMS // 3)
        * (mol % 5 != 0).repeat(1),
        resindices=mol,
        resids=mol + 1,
        resnames=np.where(mol % 4 == 0, "SOL", "WAT").astype(object),
        segindices=(mol >= 50).astype(int),
        segids=np.where(mol >= 50, "B", "A").astype(object),
    )
    return (Universe.from_arrays(traj, BOXES[box], **attrs),
            JaxUniverse.from_arrays(traj, BOXES[box], **attrs))


#: one or more expressions per keyword of the grammar.
EXPRESSIONS = [
    "all", "none", "charged", "not charged",
    "type OW", "type H*", "name H1 H2", "name O*", "name [H]? and not name H2",
    "resname SOL", "resname W?T", "segid B", "segid A and resname SOL",
    "resid 5", "resid 3:9 12 40:41", "resid > 70", "resid -1:2",
    "index 0 5 7:12", "index <= 10", "index != 3",
    "mass > 12", "mass < 2 and charged", "charge < 0", "charge == 0.417",
    "(type OW or name H1) and not resid 1:10",
    "not (segid A or resname SOL)",
    "around 2.5 index 0", "around 3.0 (resname SOL and name O)",
    "around 2.2 resid 70", "around 4 none",
    "byres around 2.0 index 17", "bysegment index 200", "byres name O",
    "same resname as index 0", "same resid as index 4 7",
    "same mass as index 1", "same segid as resid 60",
    "same index as name H2", "same charge as index 2", "same type as index 9",
    "same name as index 10",
    "prop z < 4.5", "prop abs x > 16", "prop y >= 10 and prop x < 2",
    "point 1.0 1.0 1.0 3.0", "point 17.5 0.2 19.5 2.5",
    "sphzone 4.0 resid 7", "sphzone 3 none",
]


@pytest.mark.parametrize("box", list(BOXES))
def test_select_atoms_equals_jax(box):
    u, ju = _system(box)
    for frame in (0, 1):
        u.trajectory[frame]
        ju.trajectory[frame]
        for expression in EXPRESSIONS:
            got = u.select_atoms(expression)
            ref = ju.select_atoms(expression)
            assert isinstance(got, AtomGroup)
            np.testing.assert_array_equal(got.ix, ref.ix,
                                          err_msg=f"{box}: {expression}")


def test_every_keyword_is_exercised():
    from mdhelper_tpu_torch.core.universe import _SelectionParser

    words = {token for e in EXPRESSIONS for token in e.split()}
    grammar = _SelectionParser._KEYWORDS - {"and", "or", "not"}
    assert grammar <= words
    assert {"as", "abs", "x", "y", "z"} <= words


def test_subgroup_selection_and_identity():
    u, ju = _system()
    sub, jsub = u.atoms[30:150], ju.atoms[30:150]
    for expression in ("name O", "resid 20:30", "around 2.0 index 40",
                       "index 31 149 200", "same resname as index 33"):
        np.testing.assert_array_equal(sub.select_atoms(expression).ix,
                                      jsub.select_atoms(expression).ix)
    for prop in ("mass", "charge", "resid", "index"):
        np.testing.assert_array_equal(sub._selection_values(prop),
                                      jsub._selection_values(prop))
    with pytest.raises(ValueError, match="Unknown selection property"):
        sub._selection_values("radius")
    a, b = u.select_atoms("name O"), u.select_atoms("type OW")
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    assert hash(a) != hash(u.select_atoms("name H1"))
    assert repr(a) == repr(ju.select_atoms("name O")) == (
        "<AtomGroup with 80 atoms>")


@pytest.mark.parametrize("expression", [
    "", "name", "resid", "mass", "mass >", "around x index 1",
    "prop w < 1", "prop z 4", "point 1 2 3", "sphzone all",
    "same colour as index 1", "same name index 1", "(name O", "name O )",
    "resid 1:x", "bogus 1", "index 1 or",
])
def test_invalid_selections_raise_as_jax(expression):
    u, ju = _system()
    with pytest.raises(ValueError) as ref:
        ju.select_atoms(expression)
    with pytest.raises(ValueError) as got:
        u.select_atoms(expression)
    assert str(got.value) == str(ref.value)
