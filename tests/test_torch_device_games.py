"""The port's device games against the JAX package's, bit for bit: each of
the ten games (five base games and their seeded-level variants) through
``batched_init`` and hundreds of ``batched_reset_step`` ticks at 16 lanes
from one key with numpy-seeded random actions (every lane cuts and resets
many times), ``build_rollout`` with scripted policies at history 0 and 4,
and ``JaxGameEnv`` lanes in a ``VectorEnv``.

Both sides draw from JAX's Threefry stream (the port through
``envs/prng.py``), so no draw is injected and nothing has a tolerance:
states, frames, rewards, flags and episode returns are equal.  The port runs
its plain twins here (CPU tensors); ``tests/test_torch_kernels.py`` holds
K12 against the same twins on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rainbow_iqn_apex_tpu.envs import device_games as jgames
from rainbow_iqn_apex_tpu.envs import make_vector_env as jax_make_vector_env
from rainbow_iqn_apex_tpu_torch import convert
from rainbow_iqn_apex_tpu_torch.envs import device_games as pgames
from rainbow_iqn_apex_tpu_torch.envs import make_env, make_vector_env, prng

L = 16
NAMES = ["catch", "breakout", "freeway", "asterix", "invaders",
         "catch@var", "breakout@var", "freeway@var", "asterix@var-test", "invaders@var"]


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _key(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


def _assert_state(port_state, jax_state, what):
    got = convert.game_state_arrays(port_state)
    want = jax.device_get(jax_state)
    assert type(port_state).__name__ == type(want).__name__
    for name in want._fields:
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)),
                                      err_msg=f"{what}: {name}")


@pytest.mark.parametrize("name", NAMES)
def test_reset_step_matches_jax(name):
    """batched_init, then auto-reset ticks (520 for freeway, whose episodes
    end only by its 500-tick truncation; 300 for the others): every state
    field, frame, reward, flag and episode return equal at every tick."""
    jgame, pgame = jgames.make_device_game(name), pgames.make_device_game(name)
    ticks = 520 if name.startswith("freeway") else 300
    key = jax.random.PRNGKey(11)
    k_init, k_run = jax.random.split(key)
    jstates = jgames.batched_init(jgame, k_init, L)
    pstates = pgames.batched_init(pgame, _key(k_init), L, device="cpu")
    _assert_state(pstates, jstates, "init")
    np.testing.assert_array_equal(pgames.render(pgame, pstates).numpy(),
                                  np.asarray(jax.vmap(jgame.render)(jstates)))
    jstep = jax.jit(jgames.batched_reset_step(jgame))
    pstep = pgames.batched_reset_step(pgame)
    jep, pep = jnp.zeros(L), torch.zeros(L)
    rng = np.random.default_rng(3)
    keys = np.asarray(jax.random.split(k_run, ticks))
    cuts = 0
    for t in range(ticks):
        a = rng.integers(0, jgame.num_actions, L).astype(np.int32)
        jstates, jep, jf, jr, jterm, jtrunc, jret = jstep(jstates, jep, jnp.asarray(a), keys[t])
        pstates, pep, pf, pr, pterm, ptrunc, pret = pstep(pstates, pep, torch.from_numpy(a),
                                                          _key(keys[t]))
        what = f"{name} tick {t}"
        _assert_state(pstates, jstates, what)
        for got, want, field in ((pf, jf, "frame"), (pr, jr, "reward"), (pterm, jterm, "term"),
                                 (ptrunc, jtrunc, "trunc"), (pret, jret, "out_ret"),
                                 (pep, jep, "ep_ret")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{what}: {field}")
        cuts += int((pterm | ptrunc).sum())
    assert cuts >= L  # every game cut and reset along the way


def test_prng_draws_of_the_games():
    """The draws the games make, on their own: split, fold_in, randint
    (with a negative low), uniform with and without bounds, bernoulli."""
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    kt = _key(keys)
    np.testing.assert_array_equal(prng.fold_in(kt, 7).numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys)))
    np.testing.assert_array_equal(
        prng.randint(kt, (10,), -1, 2).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.randint(k, (10,), -1, 2, jnp.int32))(keys)))
    np.testing.assert_array_equal(
        prng.uniform(kt, (8,), 0.15, 0.5).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (8,), minval=0.15, maxval=0.5))(keys)))


# ------------------------------------------------------------- rollouts
def _script(num_actions, xp):
    """A state- and stack-based scripted policy, the same in both frameworks:
    chase the ball where there is one, else act on the stack's brightness."""

    def act(states, stack):
        total = stack.astype(xp.int32).sum(axis=(1, 2, 3)) if xp is jnp else \
            stack.to(torch.int32).sum(dim=(1, 2, 3))
        fallback = (total // 255 + states.t) % num_actions
        if hasattr(states, "ball_c"):
            toward = xp.where(states.ball_c < states.paddle, 1,
                              xp.where(states.ball_c > states.paddle, 2, 0))
            return xp.where(states.t % 5 == 0, fallback, toward).astype(xp.int32) if xp is jnp \
                else torch.where(states.t % 5 == 0, fallback, toward).to(torch.int32)
        return fallback.astype(xp.int32) if xp is jnp else fallback.to(torch.int32)

    return act


@pytest.mark.parametrize("name,history", [("catch", 0), ("catch", 4), ("breakout", 4),
                                          ("asterix@var", 0), ("invaders", 4)])
def test_build_rollout_matches_jax(name, history):
    """build_rollout: equal first-episode returns (capped at the budget)."""
    jgame, pgame = jgames.make_device_game(name), pgames.make_device_game(name)
    jact, pact = _script(jgame.num_actions, jnp), _script(pgame.num_actions, torch)
    episodes, ticks = 12, 96
    jrun = jgames.build_rollout(jgame, lambda aux, s, stack, k: jact(s, stack), episodes, ticks,
                                history=history)
    prun = pgames.build_rollout(pgame, lambda aux, s, stack, g: pact(s, stack), episodes, ticks,
                                history=history, device="cpu")
    key = jax.random.PRNGKey(21)
    want = np.asarray(jrun(None, key))
    got = prun(None, _key(key)).numpy()
    np.testing.assert_array_equal(got, want)


def test_build_rollout_masks_recurrent_actors():
    """actor_init / keep masking: an actor state counting ticks since the
    last cut drives the action; the returns agree."""
    jgame, pgame = jgames.make_device_game("catch"), pgames.make_device_game("catch")
    episodes, ticks = 8, 40

    def jfn(aux, s, stack, k, actor):
        (count,) = actor
        return (count % 3).astype(jnp.int32), (count + 1,)

    def pfn(aux, s, stack, g, actor):
        (count,) = actor
        return (count % 3).to(torch.int32), (count + 1,)

    jrun = jgames.build_rollout(jgame, jfn, episodes, ticks,
                                actor_init=lambda n: (jnp.zeros(n, jnp.int32),))
    prun = pgames.build_rollout(pgame, pfn, episodes, ticks, device="cpu",
                                actor_init=lambda n: (torch.zeros(n, dtype=torch.int32),))
    key = jax.random.PRNGKey(4)
    np.testing.assert_array_equal(prun(None, _key(key)).numpy(), np.asarray(jrun(None, key)))


# ----------------------------------------------------------- host adapter
@pytest.mark.parametrize("name", ["catch", "breakout@var", "invaders"])
def test_jaxgame_vector_env_matches_jax(name):
    """``jaxgame:`` lanes in a VectorEnv: frames, rewards, flags and episode
    returns equal over 150 lockstep ticks (lanes reset on their own key
    streams)."""
    lanes = 3
    jenv = jax_make_vector_env(f"jaxgame:{name}", lanes, seed=5)
    penv = make_vector_env(f"jaxgame:{name}", lanes, seed=5, device="cpu")
    assert penv.num_actions == jenv.num_actions and penv.frame_shape == jenv.frame_shape
    np.testing.assert_array_equal(penv.reset(), jenv.reset())
    rng = np.random.default_rng(9)
    ended = 0
    for _ in range(150):
        a = rng.integers(0, jenv.num_actions, lanes)
        for got, want in zip(penv.step(a), jenv.step(a)):
            np.testing.assert_array_equal(got, want)
        ended += int(np.sum(~np.isnan(want)))
    assert ended > 0


def test_make_env_routes_jaxgame_and_refuses_others():
    env = make_env("jaxgame:freeway", seed=1, device="cpu")
    assert isinstance(env, pgames.JaxGameEnv) and env.frame_shape == (80, 80)
    assert env.reset().shape == (80, 80)
    for bad in ("gym:CartPole-v1", "procgen:coinrun"):
        with pytest.raises(NotImplementedError):
            make_env(bad)
    with pytest.raises(ValueError, match="unknown jax game"):
        pgames.make_device_game("pong")
    with pytest.raises(ValueError, match="unknown variant"):
        pgames.make_device_game("catch@nope")
    assert pgames.tick_budget("breakout@var") == jgames.tick_budget("breakout@var") == 512


def test_k12_wrappers_run_the_twins_on_cpu_without_counting():
    """On CPU tensors every K12 entry runs the plain twins and counts no
    launch; the tick updates the states and returns in place."""
    from rainbow_iqn_apex_tpu_torch.kernels import launches
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_init, game_render, game_tick

    game = pgames.make_device_game("invaders@var")
    before = launches["K12_device_games"]
    state, frames = game_init(game, prng.prng_key(1), 4, torch.device("cpu"))
    assert torch.equal(game_render(game, state), frames)
    t_before, ep = state.t.clone(), torch.zeros(4)
    game_tick(game, state, ep, torch.full((4,), 3, dtype=torch.int32), prng.prng_key(2))
    assert torch.equal(state.t, t_before + 1)
    assert launches["K12_device_games"] == before
