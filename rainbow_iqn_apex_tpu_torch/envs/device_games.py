"""The device games of the port: Atari-class dynamics on the card.

Counterpart of ``rainbow_iqn_apex_tpu/envs/device_games.py``, with the same
names: five games in the MinAtar family (Young & Tian, arXiv:1903.03176) on
10x10 logic grids, their seeded-level variants (``"<game>@var"`` draws each
episode's level from a train pool of 16, ``"@var-test"`` from a held-out
pool of 16), the batched auto-reset tick, the rollout core of the in-graph
eval and a host adapter.  Frames are uint8 [G*cell, G*cell] (80x80), as
the reference's observation contract.

What differs in form from the JAX module, none of it in value:

- A game's state is a ``NamedTuple`` of tensors whose leading axis is the
  lane, with the JAX state's field names (``convert.py`` maps one onto the
  other).  ``init``, ``step`` and ``render`` here are plain torch over the
  batch: the twins of K12.
- Randomness is JAX's own Threefry stream (``envs/prng.py``), so a
  trajectory from a given key is bit-equal to the JAX package's.  The
  per-lane keys of ``init`` / ``step`` are int64 [L, 2] tensors; the one key
  of ``batched_init`` / ``batched_reset_step`` lives on the host (it is a
  function of the host's key stream alone), and K12 takes it by value.
- ``batched_reset_step``'s step updates the states and episode returns in
  place, on the card through K12 (``kernels/device_games.py``), on the CPU
  through the twins.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from rainbow_iqn_apex_tpu_torch.envs import prng
from rainbow_iqn_apex_tpu_torch.envs.base import Env, TimeStep
from rainbow_iqn_apex_tpu_torch.ops.act import DeviceLike, resolve_device

G = 10  # logic grid is GxG for every game

# render intensities (distinct so the conv net can tell entities apart)
I_PLAYER = 140
I_BALL = 255
I_BRICK = 90
I_ENEMY = 200
I_GOLD = 255
I_BULLET = 255


def _upscale(grid: torch.Tensor, cell: int) -> torch.Tensor:
    """[L, G, G] u8 -> [L, G*cell, G*cell] u8 (nearest-neighbour)."""
    return grid.repeat_interleave(cell, dim=1).repeat_interleave(cell, dim=2)


def _rand_signs(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """Uniform +-1 int32 draw, the shared direction-sampling convention."""
    return torch.where(prng.bernoulli(keys, 0.5, shape), 1, -1).to(torch.int32)


def _i32(value, lanes: int, device, shape=()) -> torch.Tensor:
    return torch.full((lanes, *shape), value, dtype=torch.int32, device=device)


def _set(grid: torch.Tensor, r: torch.Tensor, c: torch.Tensor, value: int) -> torch.Tensor:
    """grid[l, r[l], c[l]] = value for every lane (a scatter, no host scalar)."""
    flat = grid.view(grid.shape[0], -1)
    flat.scatter_(1, (r.long() * grid.shape[-1] + c.long())[:, None], value)
    return grid


def _max_at(grid: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
            value: torch.Tensor) -> torch.Tensor:
    """grid[l, r[l, i], c[l, i]] = max(that, value[l, i]) (``.at[].max``)."""
    flat = grid.view(grid.shape[0], -1)
    idx = r.long() * grid.shape[-1] + c.long()
    flat.scatter_reduce_(1, idx.reshape(grid.shape[0], -1),
                         value.reshape(grid.shape[0], -1).to(grid.dtype), "amax")
    return grid


def _table(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


def _first_true(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.argmax`` of a bool array: the first True, 0 where none."""
    return x.to(torch.uint8).argmax(dim=dim).to(torch.int32)


class DeviceGame:
    """Base: a game over a batch of lanes.  ``init`` / ``step`` / ``render``
    take and give [L, ...] tensors."""

    num_actions: int
    name: str
    # frame = (G*cell, G*cell).  cell=8 -> 80x80: the canonical DQN trunk
    # reduces that to a 6x6 feature grid
    cell: int = 8
    pool_base: int = 0
    pool_size: int = 0
    cap: int = 0
    state_type: type

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return (G * self.cell, G * self.cell)

    def init(self, keys: torch.Tensor):  # -> state
        raise NotImplementedError

    def step(self, state, action: torch.Tensor, keys: torch.Tensor):
        """-> (state, reward f32 [L], term bool [L], trunc bool [L])."""
        raise NotImplementedError

    def render(self, state) -> torch.Tensor:  # -> [L, H, W] uint8
        raise NotImplementedError


# --------------------------------------------------------------------------
# Catch
# --------------------------------------------------------------------------
_MOVE3 = (0, -1, 1)


class CatchState(NamedTuple):
    ball_r: torch.Tensor  # [L] i32
    ball_c: torch.Tensor
    paddle: torch.Tensor
    t: torch.Tensor


class CatchGame(DeviceGame):
    """Ball falls straight down; catch it with the bottom paddle.
    Actions: 0=stay 1=left 2=right.  +1 catch / -1 miss, episode ends at the
    bottom row."""

    num_actions = 3
    name = "catch"
    state_type = CatchState

    def init(self, keys):
        L, dev = keys.shape[0], keys.device
        return CatchState(ball_r=_i32(0, L, dev), ball_c=prng.randint(keys, (), 0, G),
                          paddle=_i32(G // 2, L, dev), t=_i32(0, L, dev))

    def step(self, s, action, keys):
        move = _table(_MOVE3, s.t.device)[action.long()]
        paddle = (s.paddle + move).clamp(0, G - 1)
        ball_r = s.ball_r + 1
        ball_c = self._ball_col(s, ball_r)
        terminal = ball_r == G - 1
        hit = torch.where(paddle == ball_c, 1.0, -1.0)
        reward = torch.where(terminal, hit, 0.0).to(torch.float32)
        ns = s._replace(ball_r=ball_r, ball_c=ball_c, paddle=paddle, t=s.t + 1)
        return ns, reward, terminal, torch.zeros_like(terminal)

    def _ball_col(self, s, ball_r):
        """Ball column on entering row ``ball_r`` (the variant adds wind)."""
        return s.ball_c

    def render(self, s):
        grid = torch.zeros((s.t.shape[0], G, G), dtype=torch.uint8, device=s.t.device)
        _set(grid, s.ball_r, s.ball_c, I_BALL)
        _set(grid, torch.full_like(s.paddle, G - 1), s.paddle, I_PLAYER)
        return _upscale(grid, self.cell)


# --------------------------------------------------------------------------
# Breakout
# --------------------------------------------------------------------------
class BreakoutState(NamedTuple):
    paddle: torch.Tensor  # [L] i32 col
    ball_r: torch.Tensor
    ball_c: torch.Tensor
    dr: torch.Tensor  # in {-1, +1}
    dc: torch.Tensor
    bricks: torch.Tensor  # [L, G, G] bool (rows 1..3 used)
    t: torch.Tensor


class BreakoutGame(DeviceGame):
    """Paddle/ball/brick-wall: +1 per brick, wall respawns when cleared,
    episode ends when the ball passes the paddle.  Actions: 0=stay 1=left
    2=right."""

    num_actions = 3
    name = "breakout"
    state_type = BreakoutState
    BRICK_ROWS = (1, 2, 3)

    def _wall(self, lanes: int, device) -> torch.Tensor:
        bricks = torch.zeros((lanes, G, G), dtype=torch.bool, device=device)
        bricks[:, list(self.BRICK_ROWS)] = True
        return bricks

    def init(self, keys):
        L, dev = keys.shape[0], keys.device
        k = prng.split(keys, 2)
        return BreakoutState(
            paddle=_i32(G // 2, L, dev), ball_r=_i32(4, L, dev),
            ball_c=prng.randint(k[:, 0], (), 0, G), dr=_i32(1, L, dev),
            dc=_rand_signs(k[:, 1]), bricks=self._wall(L, dev), t=_i32(0, L, dev))

    def step(self, s, action, keys):
        L = s.t.shape[0]
        move = _table(_MOVE3, s.t.device)[action.long()]
        paddle = (s.paddle + move).clamp(0, G - 1)

        # diagonal flight with side/top reflection
        nc = s.ball_c + s.dc
        dc = torch.where((nc < 0) | (nc > G - 1), -s.dc, s.dc)
        nc = nc.clamp(0, G - 1)
        nr = s.ball_r + s.dr
        dr = torch.where(nr < 0, 1, s.dr).to(torch.int32)
        nr = torch.where(nr < 0, 1, nr).to(torch.int32)

        # brick hit: clear it, bounce back (ball keeps its old row)
        cell = (nr.clamp(0, G - 1) * G + nc).long()[:, None]
        flat = s.bricks.reshape(L, G * G)
        hit = flat.gather(1, cell)[:, 0]
        bricks = flat.clone().scatter_(1, cell, False)
        reward = hit.to(torch.float32)
        dr = torch.where(hit, -dr, dr)
        nr = torch.where(hit, s.ball_r, nr)

        # paddle plane: bounce if aligned, lose otherwise
        at_bottom = nr >= G - 1
        caught = at_bottom & (nc == paddle)
        dr = torch.where(caught, -1, dr).to(torch.int32)
        nr = torch.where(caught, G - 2, nr).to(torch.int32)
        terminal = at_bottom & ~caught

        # a cleared wall respawns
        cleared = ~bricks.any(dim=1)
        bricks = torch.where(cleared[:, None], self._respawn(s).reshape(L, G * G), bricks)
        ns = s._replace(paddle=paddle, ball_r=nr, ball_c=nc, dr=dr, dc=dc,
                        bricks=bricks.reshape(L, G, G), t=s.t + 1)
        return ns, reward, terminal, torch.zeros_like(terminal)

    def _respawn(self, s) -> torch.Tensor:
        return self._wall(s.t.shape[0], s.t.device)

    def render(self, s):
        grid = torch.where(s.bricks, I_BRICK, 0).to(torch.uint8)
        _set(grid, s.ball_r, s.ball_c, I_BALL)
        _set(grid, torch.full_like(s.paddle, G - 1), s.paddle, I_PLAYER)
        return _upscale(grid, self.cell)


# --------------------------------------------------------------------------
# Freeway
# --------------------------------------------------------------------------
class FreewayState(NamedTuple):
    chicken: torch.Tensor  # [L] i32 row (col fixed at CHICKEN_COL)
    cars: torch.Tensor  # [L, 8] i32 col of the car in lane rows 1..8
    t: torch.Tensor


class FreewayGame(DeviceGame):
    """Cross 8 lanes of traffic: +1 at the top (then restart at the bottom);
    a collision sends the chicken back down.  No terminal state: episodes
    end by time-limit truncation (``cap`` ticks)."""

    num_actions = 3  # 0=stay 1=up 2=down
    name = "freeway"
    state_type = FreewayState
    CHICKEN_COL = 4
    # per-lane (speed, direction): a car advances every `speed` ticks
    SPEEDS = (2, 3, 2, 4, 2, 3, 4, 2)
    DIRS = (1, -1, 1, -1, -1, 1, -1, 1)

    def __init__(self, cap: int = 500):
        self.cap = cap

    def init(self, keys):
        L, dev = keys.shape[0], keys.device
        return FreewayState(chicken=_i32(G - 1, L, dev), cars=prng.randint(keys, (8,), 0, G),
                            t=_i32(0, L, dev))

    def _lane_dynamics(self, s):
        """(speeds, dirs), [8] or [L, 8]; the variant reads them from its state."""
        dev = s.t.device
        return _table(self.SPEEDS, dev), _table(self.DIRS, dev)

    def step(self, s, action, keys):
        move = _table(_MOVE3, s.t.device)[action.long()]
        chicken = (s.chicken + move).clamp(0, G - 1)

        speeds, dirs = self._lane_dynamics(s)
        advance = torch.remainder(s.t[:, None], speeds) == 0
        cars = torch.remainder(s.cars + torch.where(advance, dirs, 0), G).to(torch.int32)

        # lanes are rows 1..8; a car in the chicken's row at the chicken's col?
        lane = chicken - 1  # -1 or 8+ when off the road
        on_road = (lane >= 0) & (lane < 8)
        car_col = cars.gather(1, lane.clamp(0, 7).long()[:, None])[:, 0]
        hit = on_road & (car_col == self.CHICKEN_COL)
        chicken = torch.where(hit, G - 1, chicken).to(torch.int32)

        scored = chicken == 0
        reward = scored.to(torch.float32)
        chicken = torch.where(scored, G - 1, chicken).to(torch.int32)
        t = s.t + 1
        trunc = t >= self.cap
        ns = s._replace(chicken=chicken, cars=cars, t=t)
        return ns, reward, torch.zeros_like(trunc), trunc

    def render(self, s):
        L = s.t.shape[0]
        grid = torch.zeros((L, G, G), dtype=torch.uint8, device=s.t.device)
        rows = torch.arange(1, 9, device=s.t.device).expand(L, 8)
        grid.view(L, -1).scatter_(1, (rows * G + s.cars.long()), I_ENEMY)
        _set(grid, s.chicken, torch.full_like(s.chicken, self.CHICKEN_COL), I_PLAYER)
        return _upscale(grid, self.cell)


# --------------------------------------------------------------------------
# Asterix
# --------------------------------------------------------------------------
class AsterixState(NamedTuple):
    pr: torch.Tensor  # [L] player row/col, i32
    pc: torch.Tensor
    active: torch.Tensor  # [L, 8] bool: one entity per lane (rows 1..8)
    col: torch.Tensor  # [L, 8] i32
    dirn: torch.Tensor  # [L, 8] i32 in {-1, +1}
    gold: torch.Tensor  # [L, 8] bool: collectible vs lethal
    t: torch.Tensor


_DMOVE5 = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0))


class AsterixGame(DeviceGame):
    """Dodge enemies, collect gold.  Entities stream through 8 lanes; walking
    into gold is +1, into an enemy is death.  Actions: 0=stay 1=left 2=right
    3=up 4=down (player confined to the road rows 1..8)."""

    num_actions = 5
    name = "asterix"
    state_type = AsterixState
    SPAWN_P = 0.25  # per empty lane per tick
    MOVE_EVERY = 2  # entities advance every 2nd tick

    def _lane_speeds(self, s):
        return torch.full((8,), self.MOVE_EVERY, dtype=torch.int32, device=s.t.device)

    def _spawn_dirs(self, s, keys):
        return _rand_signs(keys, (8,))

    def _gold_probs(self, s):
        return torch.full((8,), 1.0 / 3.0, dtype=torch.float32, device=s.t.device)

    def init(self, keys):
        L, dev = keys.shape[0], keys.device
        return AsterixState(
            pr=_i32(G // 2, L, dev), pc=_i32(G // 2, L, dev),
            active=torch.zeros((L, 8), dtype=torch.bool, device=dev), col=_i32(0, L, dev, (8,)),
            dirn=_i32(1, L, dev, (8,)), gold=torch.zeros((L, 8), dtype=torch.bool, device=dev),
            t=_i32(0, L, dev))

    def step(self, s, action, keys):
        k = prng.split(keys, 3)
        dmove = _table(_DMOVE5, s.t.device)[action.long()]
        pr = (s.pr + dmove[:, 0]).clamp(1, 8)
        pc = (s.pc + dmove[:, 1]).clamp(0, G - 1)

        # advance entities on their beat; deactivate on exit
        advance = s.active & (torch.remainder(s.t[:, None], self._lane_speeds(s)) == 0)
        col = s.col + torch.where(advance, s.dirn, 0)
        exited = (col < 0) | (col > G - 1)
        active = s.active & ~exited
        col = col.clamp(0, G - 1)

        # spawn into empty lanes (left edge moving right / right edge moving left)
        spawn = ~active & (prng.uniform(k[:, 0], (8,)) < self.SPAWN_P)
        new_dir = self._spawn_dirs(s, k[:, 1])
        new_gold = prng.uniform(k[:, 2], (8,)) < self._gold_probs(s)
        dirn = torch.where(spawn, new_dir, s.dirn).to(torch.int32)
        col = torch.where(spawn, torch.where(new_dir > 0, 0, G - 1), col).to(torch.int32)
        gold = torch.where(spawn, new_gold, s.gold)
        active = active | spawn

        # collision in the player's lane
        lane = (pr - 1).long()[:, None]
        act_l = active.gather(1, lane)[:, 0]
        gold_l = gold.gather(1, lane)[:, 0]
        collide = act_l & (col.gather(1, lane)[:, 0] == pc)
        hit_gold = collide & gold_l
        terminal = collide & ~gold_l
        reward = hit_gold.to(torch.float32)
        active = active.scatter(1, lane, (act_l & ~hit_gold)[:, None])
        ns = s._replace(pr=pr, pc=pc, active=active, col=col, dirn=dirn, gold=gold, t=s.t + 1)
        return ns, reward, terminal, torch.zeros_like(terminal)

    def render(self, s):
        L = s.t.shape[0]
        grid = torch.zeros((L, G, G), dtype=torch.uint8, device=s.t.device)
        rows = torch.arange(1, 9, device=s.t.device).expand(L, 8)
        val = torch.where(s.active, torch.where(s.gold, I_GOLD, I_ENEMY), 0)
        _max_at(grid, rows, s.col, val)
        _set(grid, s.pr, s.pc, I_PLAYER)
        return _upscale(grid, self.cell)


# --------------------------------------------------------------------------
# Space Invaders
# --------------------------------------------------------------------------
class InvadersState(NamedTuple):
    pc: torch.Tensor  # [L] player col (row G-1), i32
    aliens: torch.Tensor  # [L, G, G] bool (block starts rows 1..4, cols 2..7)
    adir: torch.Tensor  # march direction
    shot_r: torch.Tensor  # player bullet (-1 row = inactive)
    shot_c: torch.Tensor
    bomb_r: torch.Tensor  # alien bomb (-1 row = inactive)
    bomb_c: torch.Tensor
    t: torch.Tensor


class InvadersGame(DeviceGame):
    """March-and-shoot: +1 per alien; death by bomb or by the fleet reaching
    the bottom row; the fleet respawns when cleared.  Actions: 0=stay 1=left
    2=right 3=fire."""

    num_actions = 4
    name = "invaders"
    state_type = InvadersState
    MARCH_EVERY = 4  # fleet advances every 4th tick
    BOMB_EVERY = 6  # a random front-line alien bombs every 6th tick

    def _fleet(self, lanes: int, device) -> torch.Tensor:
        a = torch.zeros((lanes, G, G), dtype=torch.bool, device=device)
        a[:, 1:5, 2:8] = True
        return a

    def _march_every(self, s):
        return self.MARCH_EVERY

    def _bomb_every(self, s):
        return self.BOMB_EVERY

    def _respawn_fleet(self, s) -> torch.Tensor:
        return self._fleet(s.t.shape[0], s.t.device)

    def init(self, keys):
        L, dev = keys.shape[0], keys.device
        return InvadersState(
            pc=_i32(G // 2, L, dev), aliens=self._fleet(L, dev), adir=_i32(1, L, dev),
            shot_r=_i32(-1, L, dev), shot_c=_i32(0, L, dev), bomb_r=_i32(-1, L, dev),
            bomb_c=_i32(0, L, dev), t=_i32(0, L, dev))

    def step(self, s, action, keys):
        L, dev = s.t.shape[0], s.t.device
        move = _table((0, -1, 1, 0), dev)[action.long()]
        pc = (s.pc + move).clamp(0, G - 1)

        # fire: one player bullet in flight at a time
        fire = (action == 3) & (s.shot_r < 0)
        shot_r = torch.where(fire, G - 2, s.shot_r - (s.shot_r >= 0).to(torch.int32))
        shot_c = torch.where(fire, pc, s.shot_c).to(torch.int32)

        # the bullet hits the alien it flies into
        shot_live = shot_r >= 0
        cell = (shot_r.clamp(0, G - 1) * G + shot_c).long()[:, None]
        flat = s.aliens.reshape(L, G * G)
        hit = shot_live & flat.gather(1, cell)[:, 0]
        aliens = flat.scatter(1, cell, flat.gather(1, cell) & ~hit[:, None]).reshape(L, G, G)
        reward = hit.to(torch.float32)
        shot_r = torch.where(hit, -1, shot_r).to(torch.int32)

        # fleet march: sideways on the beat, down + reverse at an edge
        march = torch.remainder(s.t, self._march_every(s)) == 0
        cols_occ = aliens.any(dim=1)
        leftmost = _first_true(cols_occ)
        rightmost = G - 1 - _first_true(cols_occ.flip(-1))
        at_edge = torch.where(s.adir > 0, rightmost >= G - 1, leftmost <= 0)
        drop = march & at_edge & cols_occ.any(dim=1)
        shift = march & ~at_edge
        aliens = torch.where(drop[:, None, None], aliens.roll(1, dims=1), aliens)
        adir = torch.where(drop, -s.adir, s.adir)
        rolled = torch.where((s.adir > 0)[:, None, None], aliens.roll(1, dims=2),
                             aliens.roll(-1, dims=2))
        aliens = torch.where(shift[:, None, None], rolled, aliens)

        # bombing: the occupied column nearest a random pick releases a bomb
        # from its lowest alien on the bomb beat
        occ = aliens.any(dim=1)
        bomb_due = ((torch.remainder(s.t, self._bomb_every(s)) == 0) & (s.bomb_r < 0)
                    & occ.any(dim=1))
        pick = prng.randint(keys, (), 0, G)
        dist = torch.where(occ, (torch.arange(G, device=dev) - pick[:, None]).abs(), G + 1)
        bcol = dist.argmin(dim=1).to(torch.int32)
        column = aliens.gather(2, bcol.long()[:, None, None].expand(L, G, 1))[:, :, 0]
        lowest = G - 1 - _first_true(column.flip(-1))
        bomb_r = torch.where(bomb_due, lowest + 1, s.bomb_r + (s.bomb_r >= 0).to(torch.int32))
        bomb_c = torch.where(bomb_due, bcol, s.bomb_c).to(torch.int32)
        bomb_r = torch.where(bomb_r > G - 1, -1, bomb_r).to(torch.int32)

        # deaths: a bomb reaches the player row at the player's col, or the
        # fleet reaches the bottom row
        killed = (bomb_r == G - 1) & (bomb_c == pc)
        terminal = killed | aliens[:, G - 1].any(dim=1)

        # a cleared fleet respawns
        cleared = ~aliens.reshape(L, -1).any(dim=1)
        aliens = torch.where(cleared[:, None, None], self._respawn_fleet(s), aliens)
        ns = s._replace(pc=pc, aliens=aliens, adir=adir.to(torch.int32), shot_r=shot_r,
                        shot_c=shot_c, bomb_r=bomb_r, bomb_c=bomb_c, t=s.t + 1)
        return ns, reward, terminal, torch.zeros_like(terminal)

    def render(self, s):
        grid = torch.where(s.aliens, I_ENEMY, 0).to(torch.uint8)
        for r, c in ((s.shot_r, s.shot_c), (s.bomb_r, s.bomb_c)):
            live = torch.where(r >= 0, I_BULLET, 0)
            _max_at(grid, r.clamp(0, G - 1), c, live)
        _set(grid, torch.full_like(s.pc, G - 1), s.pc, I_PLAYER)
        return _upscale(grid, self.cell)


# --------------------------------------------------------------------------
# seeded level variants: "<game>@var" draws each episode's level from a TRAIN
# pool of seeds, "<game>@var-test" from a disjoint HELD-OUT pool.  A level is
# a deterministic function of its id (fold_in of a fixed base key); the
# per-episode randomness stays on top of the level's layout.
# --------------------------------------------------------------------------
N_TRAIN_LEVELS = 16
N_TEST_LEVELS = 16
_LEVEL_BASE_KEY = 9137


def _level_fold(level: torch.Tensor) -> torch.Tensor:
    """Level ids [L] -> the levels' layout keys [L, 2]."""
    base = prng.prng_key(_LEVEL_BASE_KEY, device=level.device)
    return prng.fold_in(base.expand(level.shape[0], 2), level.to(torch.int64))


def _draw_level(pool_base: int, pool_size: int, keys: torch.Tensor) -> torch.Tensor:
    return pool_base + prng.randint(keys, (), 0, pool_size)


class _Variant:
    """Mixin of the level-pool games: the pool and the pinned-level init."""

    def __init__(self, pool_base: int, pool_size: int):
        self.pool_base = pool_base
        self.pool_size = pool_size


class CatchVarState(NamedTuple):
    ball_r: torch.Tensor
    ball_c: torch.Tensor
    paddle: torch.Tensor
    drift: torch.Tensor  # [L, G] i32 in {-1, 0, +1}: this level's per-row wind
    t: torch.Tensor


class CatchVarGame(_Variant, CatchGame):
    """Level-randomized catch: the level fixes a per-row lateral drift (wind
    in {-1, 0, +1}, none on the terminal row) the ball rides on its way
    down; the ball's entry column stays per-episode randomness."""

    state_type = CatchVarState

    def init(self, keys):
        k = prng.split(keys, 2)
        return self._init_level(_draw_level(self.pool_base, self.pool_size, k[:, 0]), k[:, 1])

    def init_at_level(self, level, keys):
        return self._init_level(level, keys)

    def _init_level(self, level, kc):
        L, dev = kc.shape[0], kc.device
        drift = prng.randint(_level_fold(level), (G,), -1, 2)
        drift[:, G - 1] = 0  # no wind on the terminal row
        return CatchVarState(ball_r=_i32(0, L, dev), ball_c=prng.randint(kc, (), 0, G),
                             paddle=_i32(G // 2, L, dev), drift=drift, t=_i32(0, L, dev))

    def _ball_col(self, s, ball_r):
        wind = s.drift.gather(1, ball_r.long()[:, None])[:, 0]
        return (s.ball_c + wind).clamp(0, G - 1)


class BreakoutVarState(NamedTuple):
    paddle: torch.Tensor
    ball_r: torch.Tensor
    ball_c: torch.Tensor
    dr: torch.Tensor
    dc: torch.Tensor
    bricks: torch.Tensor
    wall: torch.Tensor  # [L, G, G] bool: this level's respawn template
    t: torch.Tensor


class BreakoutVarGame(_Variant, BreakoutGame):
    """Level-randomized breakout: the level fixes the brick pattern (a random
    ~3/4-density mask over rows 1..3) and the paddle start; the ball's entry
    column and direction stay per-episode randomness."""

    state_type = BreakoutVarState

    def init(self, keys):
        k = prng.split(keys, 3)
        level = _draw_level(self.pool_base, self.pool_size, k[:, 0])
        return self._init_level(level, k[:, 1], k[:, 2])

    def init_at_level(self, level, keys):
        k = prng.split(keys, 2)
        return self._init_level(level, k[:, 0], k[:, 1])

    def _init_level(self, level, kc, kd):
        L, dev = kc.shape[0], kc.device
        kw = prng.split(_level_fold(level), 2)
        mask = prng.uniform(kw[:, 0], (3, G)) < 0.75
        mask[:, 1, G // 2] = True  # a level can never be brickless
        wall = torch.zeros((L, G, G), dtype=torch.bool, device=dev)
        wall[:, 1:4] = mask
        return BreakoutVarState(
            paddle=prng.randint(kw[:, 1], (), 0, G), ball_r=_i32(4, L, dev),
            ball_c=prng.randint(kc, (), 0, G), dr=_i32(1, L, dev), dc=_rand_signs(kd),
            bricks=wall.clone(), wall=wall, t=_i32(0, L, dev))

    def _respawn(self, s):
        return s.wall


class FreewayVarState(NamedTuple):
    chicken: torch.Tensor
    cars: torch.Tensor
    speeds: torch.Tensor  # [L, 8] i32: this level's per-lane beat
    dirs: torch.Tensor  # [L, 8] i32 in {-1, +1}
    t: torch.Tensor


class FreewayVarGame(FreewayGame):
    """Level-randomized freeway: the level fixes per-lane speeds (2..4) and
    directions; the cars' starting phases stay per-episode randomness."""

    state_type = FreewayVarState

    def __init__(self, pool_base: int, pool_size: int, cap: int = 500):
        super().__init__(cap=cap)
        self.pool_base = pool_base
        self.pool_size = pool_size

    def init(self, keys):
        k = prng.split(keys, 2)
        return self._init_level(_draw_level(self.pool_base, self.pool_size, k[:, 0]), k[:, 1])

    def init_at_level(self, level, keys):
        return self._init_level(level, keys)

    def _init_level(self, level, kc):
        L, dev = kc.shape[0], kc.device
        ks = prng.split(_level_fold(level), 2)
        return FreewayVarState(
            chicken=_i32(G - 1, L, dev), cars=prng.randint(kc, (8,), 0, G),
            speeds=prng.randint(ks[:, 0], (8,), 2, 5), dirs=_rand_signs(ks[:, 1], (8,)),
            t=_i32(0, L, dev))

    def _lane_dynamics(self, s):
        return s.speeds, s.dirs


class AsterixVarState(NamedTuple):
    pr: torch.Tensor
    pc: torch.Tensor
    active: torch.Tensor
    col: torch.Tensor
    dirn: torch.Tensor
    gold: torch.Tensor
    speeds: torch.Tensor  # [L, 8] i32: this level's per-lane entity beat
    lane_dir: torch.Tensor  # [L, 8] i32: this level's fixed per-lane stream dir
    gold_p: torch.Tensor  # [L, 8] f32: this level's per-lane gold probability
    t: torch.Tensor


class AsterixVarGame(_Variant, AsterixGame):
    """Level-randomized asterix: the level fixes per-lane entity speeds (beat
    1..3), a stream direction per lane and a per-lane gold probability;
    spawn timing stays per-episode randomness."""

    state_type = AsterixVarState

    def init(self, keys):
        return self.init_at_level(_draw_level(self.pool_base, self.pool_size, keys), keys)

    def init_at_level(self, level, keys):
        """The level fixes the whole initial state; ``keys`` only size it."""
        L, dev = keys.shape[0], keys.device
        k = prng.split(_level_fold(level), 3)
        base = AsterixGame.init(self, keys)
        return AsterixVarState(
            **base._asdict() | dict(
                speeds=prng.randint(k[:, 0], (8,), 1, 4), lane_dir=_rand_signs(k[:, 1], (8,)),
                gold_p=prng.uniform(k[:, 2], (8,), 0.15, 0.5), t=_i32(0, L, dev)))

    def _lane_speeds(self, s):
        return s.speeds

    def _spawn_dirs(self, s, keys):
        return s.lane_dir

    def _gold_probs(self, s):
        return s.gold_p


class InvadersVarState(NamedTuple):
    pc: torch.Tensor
    aliens: torch.Tensor
    adir: torch.Tensor
    shot_r: torch.Tensor
    shot_c: torch.Tensor
    bomb_r: torch.Tensor
    bomb_c: torch.Tensor
    fleet: torch.Tensor  # [L, G, G] bool: this level's respawn template
    march_every: torch.Tensor  # [L] i32: this level's march beat
    bomb_every: torch.Tensor  # [L] i32: this level's bomb beat
    t: torch.Tensor


class InvadersVarGame(_Variant, InvadersGame):
    """Level-randomized invaders: the level fixes the initial fleet (a
    ~4/5-density mask over the 4x6 block), the march beat (3..5), the bomb
    beat (4..8) and the starting march direction; the bomb columns stay
    per-episode randomness."""

    state_type = InvadersVarState

    def init(self, keys):
        return self.init_at_level(_draw_level(self.pool_base, self.pool_size, keys), keys)

    def init_at_level(self, level, keys):
        """The level fixes the whole initial state; ``keys`` only size it."""
        L, dev = keys.shape[0], keys.device
        k = prng.split(_level_fold(level), 4)
        mask = prng.uniform(k[:, 0], (4, 6)) < 0.8
        mask[:, 0, 3] = True  # a level can never start alien-less
        fleet = torch.zeros((L, G, G), dtype=torch.bool, device=dev)
        fleet[:, 1:5, 2:8] = mask
        return InvadersVarState(
            pc=_i32(G // 2, L, dev), aliens=fleet.clone(), adir=_rand_signs(k[:, 3]),
            shot_r=_i32(-1, L, dev), shot_c=_i32(0, L, dev), bomb_r=_i32(-1, L, dev),
            bomb_c=_i32(0, L, dev), fleet=fleet,
            march_every=prng.randint(k[:, 1], (), 3, 6),
            bomb_every=prng.randint(k[:, 2], (), 4, 9), t=_i32(0, L, dev))

    def _march_every(self, s):
        return s.march_every

    def _bomb_every(self, s):
        return s.bomb_every

    def _respawn_fleet(self, s):
        return s.fleet


VARIANT_GAMES = {
    "catch": CatchVarGame,
    "breakout": BreakoutVarGame,
    "freeway": FreewayVarGame,
    "asterix": AsterixVarGame,
    "invaders": InvadersVarGame,
}

# --------------------------------------------------------------------------
# registry + batched auto-reset step (the Anakin building block)
# --------------------------------------------------------------------------
GAMES = {
    "catch": CatchGame,
    "breakout": BreakoutGame,
    "freeway": FreewayGame,
    "asterix": AsterixGame,
    "invaders": InvadersGame,
}

# the suite's episode cap, in ticks: eval rollouts score each lane's FIRST
# episode, and a lane still mid-episode at the cap scores its partial return
EPISODE_TICK_BUDGET = {"catch": 64, "breakout": 512, "freeway": 600,
                       "asterix": 512, "invaders": 512}


def make_device_game(name: str) -> DeviceGame:
    if "@" in name:
        base, variant = name.split("@", 1)
        cls = VARIANT_GAMES.get(base)
        if cls is None:
            raise ValueError(
                f"game '{base}' has no seeded-variant mode (have: "
                f"{', '.join(sorted(VARIANT_GAMES))})")
        if variant == "var":
            return cls(0, N_TRAIN_LEVELS)
        if variant == "var-test":
            return cls(N_TRAIN_LEVELS, N_TEST_LEVELS)
        raise ValueError(
            f"unknown variant '@{variant}' for '{base}' (want '@var' for the "
            "train pool or '@var-test' for the held-out pool)")
    try:
        return GAMES[name]()
    except KeyError:
        raise ValueError(
            f"unknown jax game '{name}' (have: {', '.join(sorted(GAMES))})") from None


def tick_budget(name: str, default: int = 512) -> int:
    """Episode tick cap for a game id, variant-suffix aware."""
    return EPISODE_TICK_BUDGET.get(name.split("@", 1)[0], default)


def batched_init(game: DeviceGame, key, lanes: int, device: DeviceLike = None):
    """Per-lane independent initial states from ``split(key, lanes)``: an
    [L, ...] state on ``device`` (``cuda:0`` unless named; K12 there)."""
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_init

    state, _frames = game_init(game, prng.as_key(key), lanes, resolve_device(device))
    return state


def batched_reset_step(game: DeviceGame) -> Callable[..., Tuple[Any, ...]]:
    """Returns ``step(states, ep_rets, actions, key) -> (states, ep_rets,
    frames, reward, terminal, truncated & ~terminal, out_ret)`` for
    [L]-batched lanes with auto-reset: on a terminal or a truncation the
    lane's state is re-initialised and its frame is the new episode's first
    observation (the ``VectorEnv.step`` contract).  ``out_ret`` is the
    completed episode's return on cut ticks and NaN elsewhere.  Per lane
    the keys are ``split(key, L)[l]``, then ``(k_step, k_reset) =
    split(k)``, as the JAX step.  ``states`` and ``ep_rets`` are updated in
    place (K12 on the card, the plain twins on the CPU); ``key`` is a host
    key."""
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_tick

    def step(states, ep_rets, actions, key):
        frames, reward, term, trunc, out_ret = game_tick(game, states, ep_rets, actions,
                                                         prng.as_key(key))
        return states, ep_rets, frames, reward, term, trunc, out_ret

    return step


def render(game: DeviceGame, states) -> torch.Tensor:
    """[L, H, W] uint8 frames of ``states`` (K12's render on the card)."""
    from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_render

    return game_render(game, states)


def build_rollout(game: DeviceGame, action_fn, episodes: int, max_ticks: int,
                  history: int = 0, actor_init=None, init_fn=None, device: DeviceLike = None):
    """A ``(aux, key) -> first-episode returns [episodes]`` rollout over
    ``episodes`` parallel auto-reset lanes, the episode-accounting core of
    the trainers' in-graph eval (``train_anakin.build_fused_eval``).

    ``action_fn(aux, states, stack, generator) -> actions [episodes]``
    chooses actions from the game states (state-based scripts; ``history=0``
    skips stack upkeep) or from the device frame stack (``history=C`` keeps
    an [L, H, W, C] stack with cut-zeroing, as the training tick).  The
    rollout passes ``generator`` (the ``(aux, key, generator)`` call's
    third argument) through; the network's taus come from it.

    Recurrent actors: ``actor_init(episodes) -> actor_state`` (a tuple of
    [episodes, ...] tensors whose reset value is zero) and ``action_fn(aux,
    states, stack, generator, actor_state) -> (actions, actor_state)``; lanes
    whose episode was cut are zero-reset by the keep mask.

    ``init_fn(aux, key) -> state`` overrides the default pool init (a
    pinned-level eval).  Returns are capped, never censored: a lane whose
    first episode still runs at ``max_ticks`` scores its partial return.
    The env keys follow the JAX rollout: ``(k_init, k_scan) = split(key)``,
    then ``split(k_scan, max_ticks)`` and ``(ka, ks) = split(k)`` per tick."""
    from rainbow_iqn_apex_tpu_torch.parallel.multihost import shift_stack

    step = batched_reset_step(game)
    h, w = game.frame_shape
    dev = resolve_device(device)

    def run(aux, key, generator: Optional[torch.Generator] = None):
        key = prng.as_key(key)
        k_init, k_scan = prng.split(key, 2)
        if init_fn is not None:
            states = init_fn(aux, k_init)
            frame = render(game, states)
        else:
            from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_init

            states, frame = game_init(game, k_init, episodes, dev)
        ticks = prng.split(prng.split(k_scan, max_ticks), 2)  # [T, 2 (ka, ks), 2]
        ep = torch.zeros(episodes, dtype=torch.float32, device=dev)
        stack = torch.zeros((episodes, h, w, max(history, 1)), dtype=torch.uint8, device=dev)
        keep = torch.ones(episodes, dtype=torch.uint8, device=dev)
        first = torch.full((episodes,), float("nan"), device=dev)
        done = torch.zeros(episodes, dtype=torch.bool, device=dev)
        actor = actor_init(episodes) if actor_init is not None else ()
        for t in range(max_ticks):
            if history:
                shift_stack(stack, frame, keep)
            if actor_init is None:
                actions = action_fn(aux, states, stack, generator)
            else:
                actions, actor = action_fn(aux, states, stack, generator, actor)
            states, ep, frame, _r, term, trunc, out_ret = step(states, ep, actions,
                                                               ticks[t, 1])
            ended = ~torch.isnan(out_ret)
            first = torch.where(ended & ~done, out_ret, first)
            done = done | ended
            keep = (~(term | trunc)).to(torch.uint8)
            if actor_init is not None:
                actor = tuple(x * keep.to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
                              for x in actor)
        # capped-return semantics: an unfinished first episode scores its
        # running return (ep still tracks the first episode iff never done)
        return torch.where(done, first, ep)

    return run


# --------------------------------------------------------------------------
# host adapter: a DeviceGame as an ordinary Env (works in every trainer)
# --------------------------------------------------------------------------
class JaxGameEnv(Env):
    """Host-loop adapter of one game lane, named after the ``jaxgame:`` ids
    it serves.  Its key stream starts at ``prng_key(seed)`` and splits one
    key per reset and per step, as the JAX adapter's; the lane runs on
    ``device`` (``cuda:0`` unless named: K12 there, one launch per call)."""

    def __init__(self, name: str, seed: int = 0, device: DeviceLike = None):
        self.game = make_device_game(name)
        self.device = resolve_device(device)
        self._key = prng.prng_key(seed)
        self._state = None
        self._ret = 0.0

    @property
    def num_actions(self) -> int:
        return self.game.num_actions

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return self.game.frame_shape

    def _split(self) -> torch.Tensor:
        self._key, k = prng.split(self._key, 2)
        return k

    def reset(self) -> np.ndarray:
        from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_init

        self._state, frame = game_init(self.game, self._split(), 1, self.device, direct=True)
        self._ret = 0.0
        return frame[0].cpu().numpy()

    def step(self, action: int) -> TimeStep:
        from rainbow_iqn_apex_tpu_torch.kernels.device_games import game_step

        actions = torch.tensor([int(action)], dtype=torch.int32, device=self.device)
        frame, reward, term, trunc = game_step(self.game, self._state, actions, self._split())
        reward = float(reward[0])
        self._ret += reward
        term, trunc = bool(term[0]), bool(trunc[0])
        info = {"episode_return": self._ret} if term or trunc else None
        return TimeStep(frame[0].cpu().numpy(), reward, term, trunc, info)
