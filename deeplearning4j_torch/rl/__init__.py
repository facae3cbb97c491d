"""Reinforcement learning (RL4J: ``rl4j-core
org.deeplearning4j.rl4j.**``; port of ``deeplearning4j_tpu.rl``): MDP
protocol, replay buffer, deep Q-learning with a target network,
epsilon-greedy policy, A3C and async n-step Q-learning.

The Q-network is a framework ``MultiLayerNetwork`` whose TD update is the
supervised ``fit`` step on the network's device; replay sampling and
environment stepping stay on the host (control flow, not FLOPs).
"""
from deeplearning4j_torch.rl.mdp import MDP, SimpleGridWorld
from deeplearning4j_torch.rl.dqn import (DQNPolicy, QLearningConfiguration,
                                         QLearningDiscrete, ReplayBuffer)
from deeplearning4j_torch.rl.a3c import (A3CConfiguration, A3CDiscrete,
                                         ACPolicy,
                                         AsyncNStepQConfiguration,
                                         AsyncNStepQLearningDiscrete)

__all__ = ["MDP", "SimpleGridWorld", "QLearningDiscrete",
           "QLearningConfiguration", "ReplayBuffer", "DQNPolicy",
           "A3CDiscrete", "A3CConfiguration", "ACPolicy",
           "AsyncNStepQLearningDiscrete", "AsyncNStepQConfiguration"]
