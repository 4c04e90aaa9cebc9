select s_nationkey as n_name, year(o_orderdate) as o_year,
       sum(l_extendedprice * (1 - l_discount)
           - ps_supplycost * l_quantity) as sum_profit
from lineitem
    join orders on l_orderkey = o_orderkey
    join partsupp on l_partkey = ps_partkey and l_suppkey = ps_suppkey
    join supplier on l_suppkey = s_suppkey
where l_partkey in (select p_partkey from part where p_name like '%green%')
group by n_name, o_year
order by n_name, o_year desc
