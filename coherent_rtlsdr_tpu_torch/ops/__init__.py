"""DSP ops: conversion, phase, delay ramps, spectral statistics, lag
estimation."""
