declare q5_date_lo date default date '1994-01-01'
    in (date '1993-01-01', date '1997-01-01');
declare q5_date_hi date default date '1995-01-01'
    in (date '1994-01-01', date '1998-01-01');
with asia as (
    select n_nationkey
    from nation
        join region on n_regionkey = r_regionkey
    where r_name = 'ASIA'
)
select s_nationkey, sum(l_extendedprice * (1 - l_discount)) as revenue
from lineitem
    join orders on l_orderkey = o_orderkey
    join customer on o_custkey = c_custkey
    join supplier on l_suppkey = s_suppkey
where o_orderdate >= :q5_date_lo
  and o_orderdate < :q5_date_hi
  and c_nationkey in (select n_nationkey from asia)
  and s_nationkey in (select n_nationkey from asia)
  and c_nationkey = s_nationkey
group by s_nationkey
order by revenue desc
